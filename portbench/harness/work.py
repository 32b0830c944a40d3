"""The yardstick: peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) and the operations and bytes a layer's work needs, from its shapes
and the tokens of a forward call.

A forward record (harness/spans.py) gives "phase" (prefill, chunk or
decode), "rows" (the call's true tokens: a prompt's length without its
padding, a decode call's active slots), "start" (a prefill's or chunk's
first position), "valid" (a decode call's attended lengths, one per
active slot) and "emitted" (rows whose logits the scheduler reads).
Work items are (kind, operations, bytes, peak); bytes count each input
once and each output once.
"""

from __future__ import annotations

PEAK_INT8 = 1979e12   # dense int8 TOP/s: the rate W4A4 products run at
PEAK_BF16 = 989e12    # dense bf16 TFLOP/s
HBM_BYTES_S = 3.35e12


def gemm(m: int, k: int, n: int, out_cols=None, kind="int4_gemm"):
    """A W4A4 linear at m rows: int8 codes of x [m, k], packed int4 weights
    [n, k/2], float32 row and channel scales, bf16 output [m, out_cols]
    (out_cols: n, or the width the layer keeps, as SwiGLU's half)."""
    nbytes = m * k + n * k // 2 + 4 * m + 4 * n + 2 * m * (out_cols or n)
    return (kind, 2 * m * k * n, nbytes, PEAK_INT8)


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(ops / peak, nbytes / HBM_BYTES_S)


def attended_keys(fwd: dict) -> int:
    """Keys summed over the call's query rows (causal)."""
    if fwd["phase"] == "decode":
        return int(sum(fwd["valid"]))
    n, p = fwd["rows"], fwd["start"]
    return n * p + n * (n + 1) // 2


def least_time(items, kind: str) -> float:
    """Seconds the chip needs at least for a call's items of `kind`, each
    item (one kernel's worth of work) bounded on its own."""
    return sum(least_seconds(o, b, p) for k, o, b, p in items if k == kind)


def model_ops(items) -> float:
    return float(sum(o for _, o, _, _ in items))


def roofline_share(ctx, metric: str, kind: str):
    """A kernel group's share of its roofline in the traced slice: the
    least time the slice's work of `kind` needs over the device time of
    the kernels named under metrics/<metric>/ (None when they did not
    run)."""
    if ctx.slice is None:
        return None
    names = ctx.kernel_names(metric)
    calls = {f["n"]: f for f in ctx.forwards if f["slice"]}
    dev = sum(o["dur"] for o in ctx.slice["ops"]
              if o["fwd"] in calls and any(k in o["name"] for k in names))
    least = sum(least_time(ctx.family.work(ctx.cfg, f), kind)
                for f in calls.values())
    return 100.0 * least / dev if dev and least else None
