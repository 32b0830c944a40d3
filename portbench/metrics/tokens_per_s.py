"""Prompt tokens of the requests whose first token came in the window,
plus every output token emitted in the window, over the window's seconds
(host clock, --trace 0)."""

from portbench.harness.serve import served
from portbench.harness.stats import in_window, rate

UNIT, LAYER, MOVES, SOURCE = "tokens/s", None, None, "host_clock"


def read(ctx):
    win = ctx.win
    n = 0
    for r in served(win):
        if r.stamps and in_window(r.stamps[0], win):
            n += r.prompt_len
        n += sum(1 for s in r.stamps if in_window(s, win))
    return rate(n, win["t0"], win["t1"])
