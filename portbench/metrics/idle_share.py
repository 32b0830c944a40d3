"""Share of the traced slice's wall (device timeline between the
sentinels) in which no device op ran."""

UNIT, LAYER, MOVES, SOURCE = "%", "device", "tokens_per_s", "device_trace"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
