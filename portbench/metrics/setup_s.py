"""Process start -> the window's first measured request: imports, the
kernel build (only the first run of a checkout compiles), the model
build from the seed, the batcher and its caches, and the first wave's
prefills that fill every slot."""

UNIT, LAYER, MOVES, SOURCE = "s", None, None, "host_clock"


def read(ctx):
    return ctx.win["setup_s"]
