"""torch.cuda.max_memory_allocated() over the window, reset at its start,
in GiB: speed bought with memory (dequantized weight copies, larger
workspaces) shows here."""

UNIT, LAYER, MOVES, SOURCE = "GiB", None, None, "host_clock"


def read(ctx):
    peak = ctx.win.get("peak_bytes")
    return None if peak is None else peak / 2**30
