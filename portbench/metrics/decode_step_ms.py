"""Host wall of a decode call of the model step (its span ends in a
synchronization), averaged over the traced window's decode calls outside
the profiled slice."""

UNIT, LAYER, MOVES, SOURCE = ("ms", "model step (serving/engine.py, "
                              "models/deepseek.py)", "itl_p95_ms",
                              "program_span")


def read(ctx):
    d = [f["t1"] - f["t0"] for f in ctx.forwards
         if f["phase"] == "decode" and not f["slice"]]
    return 1e3 * sum(d) / len(d) if d else None
