"""95th percentile of every gap between consecutive output tokens of a
request, over all gaps that end in the window (host clock, --trace 0).
Tokens a step emits together (a request's first token and the decode
that follows its prefill in the same step) give a gap of 0: the user
receives them at once."""

from portbench.harness.serve import served
from portbench.harness.stats import in_window, percentile

UNIT, LAYER, MOVES, SOURCE = "ms", None, None, "host_clock"


def read(ctx):
    win = ctx.win
    vals = [(b - a) * 1e3 for r in served(win)
            for a, b in zip(r.stamps, r.stamps[1:]) if in_window(b, win)]
    return percentile(vals, 95)
