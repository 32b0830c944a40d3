"""Device ops (kernels, copies, fills) per decode call in the traced
slice: most are the eager glue's, each one a launch the host pays for."""

UNIT, LAYER, MOVES, SOURCE = ("ops", "eager glue (serving/quantized.py)",
                              "itl_p95_ms", "device_trace")


def read(ctx):
    if ctx.slice is None:
        return None
    dec = {f["n"] for f in ctx.forwards
           if f["slice"] and f["phase"] == "decode"}
    if not dec:
        return None
    return sum(1 for o in ctx.slice["ops"] if o["fwd"] in dec) / len(dec)
