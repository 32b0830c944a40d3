"""95th percentile, over every request whose first token came in the
window, of submit -> first token (host clock, --trace 1). In a closed
loop with a client per slot the batcher runs at capacity, and this tail
is set by the few steps into which several admissions crowd, so it swings
from run to run; it is reported per layer, beside the cell's rate."""

from portbench.harness.serve import served
from portbench.harness.stats import in_window, percentile

UNIT, LAYER, MOVES, SOURCE = ("ms", "scheduler (serving/batcher.py)",
                              "tokens_per_s", "host_clock")


def read(ctx):
    win = ctx.win
    vals = [(r.stamps[0] - r.submit_t) * 1e3 for r in served(win)
            if in_window(r.stamps[0], win)]
    return percentile(vals, 95)
