"""Device milliseconds of the prefill calls in the traced slice per 1,000
prompt tokens (true lengths, padding not counted)."""

UNIT, LAYER, MOVES, SOURCE = ("ms", "model step (serving/engine.py, "
                              "models/deepseek.py)", "tokens_per_s",
                              "device_trace")


def read(ctx):
    if ctx.slice is None:
        return None
    pre = {f["n"]: f["rows"] for f in ctx.forwards
           if f["slice"] and f["phase"] == "prefill"}
    tokens = sum(pre.values())
    if not tokens:
        return None
    dev = sum(o["dur"] for o in ctx.slice["ops"] if o["fwd"] in pre)
    return dev * 1e3 / (tokens / 1e3) if dev else None
