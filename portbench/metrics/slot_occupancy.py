"""Active slots over batch slots, averaged over the decode calls of the
traced window: how full the scheduler keeps the batch."""

UNIT, LAYER, MOVES, SOURCE = ("%", "scheduler (serving/batcher.py)",
                              "tokens_per_s", "program_counter")


def read(ctx):
    dec = [f["rows"] for f in ctx.forwards if f["phase"] == "decode"]
    return 100.0 * sum(dec) / (len(dec) * ctx.slots) if dec else None
