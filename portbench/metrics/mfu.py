"""The whole step's share of the chip's peak: the model's operations in
the traced slice's calls (from the layers' shapes and the calls' true
tokens: linears, routed experts, attention, head) over the slice's wall
times 1,979 dense int8 TOP/s, the rate the W4A4 products run at."""

from portbench.harness import work

UNIT, LAYER, MOVES, SOURCE = "%", "whole step", "tokens_per_s", \
    "device_trace"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl["window_s"] <= 0:
        return None
    ops = sum(work.model_ops(ctx.family.work(ctx.cfg, f))
              for f in ctx.forwards if f["slice"])
    return 100.0 * ops / (sl["window_s"] * work.PEAK_INT8) if ops else None
