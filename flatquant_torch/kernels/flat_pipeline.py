"""Flat-layout fused transform + quant pipeline (port of
flatquant_tpu/kernels/flat_pipeline.py).

Three kernels carry the fused prefill routes of the serving engine once a
prompt has 256 rows or more (serving/quantized.py `_flat_ln_quant`,
`_grouped_attn_in`, `_quant_mlp_grouped[_full]`); every tensor between
them stays in the flat [T, K] layout, K = G * 128:

    rmsnorm_right_flat           RMSNorm, then the Kronecker right factor
                                 [128, 128] per 128-column group -> bf16
    left_quant_i8_flat           the left factor [G, G] across the groups,
                                 then per-token symmetric int4 quant
    w4a4_matmul_i8_swiglu_right  the merged up||gate W4A4 GEMM with
                                 u * silu(g) and the down transform's right
                                 factor in its epilogue -> bf16

The bf16 rounding points are part of each function, whatever the caller's
compute dtype: rmsnorm_right_flat rounds the normalized row to bf16 before
the right product and emits bf16; left_quant_i8_flat takes the per-token
extrema over the bf16-rounded mixed values; the swiglu GEMM rounds the
activation to bf16 before the right product and emits bf16. The right and
left factors are used in bf16 (the JAX kernels cast them). Each plain
version (`*_ref`) rounds at exactly these points, in float32 arithmetic
otherwise.

Each wrapper launches its CUDA kernel (csrc/flat_pipeline.cu) for CUDA
tensors, or raises, and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common
from flatquant_torch.kernels.int4_matmul import (
    quant_acts_i8_ref,
    w4a4_matmul_i8_swiglu_ref,
)

_RMS = "rmsnorm_right_flat"
_LQ = "left_quant_i8_flat"
_SWI = "w4a4_matmul_i8_swiglu_right"
_LIB = "flat_pipeline"


def _group_right(x, right):
    """x [T, G*128] (bf16 values) @ right [128, 128] per column group, in
    float32 -> bf16."""
    t, k = x.shape
    r = right.to(torch.bfloat16).to(torch.float32)
    y = x.to(torch.float32).reshape(t, k // 128, 128) @ r
    return y.reshape(t, k).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# rmsnorm + Kronecker right factor
# ---------------------------------------------------------------------------


def rmsnorm_right_flat_ref(x, w, right, eps: float):
    """Plain version: bf16((x * rsqrt(mean(x^2) + eps)) * w) in float32,
    then @ bf16(right) per 128-column group (float32 sums) -> bf16."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = ((xf * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(
        torch.bfloat16)
    return _group_right(xn, right)


def launch_rmsnorm_right(name, x, w, right, eps: float, grouped: bool):
    """The launch of rows 4 and 26, one device body (csrc/flat_pipeline.cu
    `rmsnorm_right`): y bf16 [T, H], or [H/128, T, 128] when grouped. The
    factor goes in bf16, as JAX casts it (no copy when it is bf16
    already)."""
    t, h = x.shape
    req = common.require
    req(w.device == x.device and right.device == x.device, name,
        "all inputs must be on the same CUDA device")
    req(x.dtype in (torch.bfloat16, torch.float32), name,
        f"x dtype {x.dtype} must be bfloat16 or float32")
    req(h % 128 == 0 and w.numel() == h
        and tuple(right.shape) == (128, 128), name,
        f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, right "
        f"{tuple(right.shape)}")
    x = x.contiguous()
    wf = w.to(torch.float32).contiguous()
    rb = right.to(torch.bfloat16).contiguous()  # wgmma's A
    req(x.data_ptr() % 16 == 0 and wf.data_ptr() % 16 == 0, name,
        "x and w must be 16-byte aligned (16-byte loads)")
    shape = (h // 128, t, 128) if grouped else (t, h)
    y = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    entry = "fq_rmsnorm_right_grouped" if grouped else "fq_rmsnorm_right_flat"
    rc = getattr(common.lib(_LIB), entry)(
        x.data_ptr(), wf.data_ptr(), rb.data_ptr(), y.data_ptr(), t, h,
        float(eps), int(x.dtype == torch.float32), common.stream_ptr(x))
    common.check(_LIB, name, rc)
    common.LAUNCHES[name] += 1
    return y


def rmsnorm_right_flat(x, w, right, eps: float):
    """RMSNorm(x) * w, then the Kronecker right factor per 128-column
    group. x [T, H] bf16 or f32, H % 128 == 0; w [H]; right [128, 128].
    Returns bf16 [T, H]. CUDA tensors launch the kernel or raise; CPU
    tensors run the plain version."""
    if x.device.type == "cpu":
        return rmsnorm_right_flat_ref(x, w, right, eps)
    return launch_rmsnorm_right(_RMS, x, w, right, eps, grouped=False)


# ---------------------------------------------------------------------------
# left Kronecker factor + per-token quant
# ---------------------------------------------------------------------------


def left_quant_i8_flat_ref(left_t, x, clip=None, q_max: int = 7):
    """Plain version: z = bf16(left_t @ x grouped) in float32 sums, then
    the serving per-token scale rule on z: xmax/xmin clipped by their LAC
    ratios, scale = max(|xmin|, xmax) / q_max (1 for a zero row), codes
    round-half-even(z / scale) clamped to [-q_max-1, q_max]."""
    t, k = x.shape
    g = k // 128
    lt = left_t.to(torch.bfloat16).to(torch.float32)
    xg = x.to(torch.float32).reshape(t, g, 128)
    z = torch.einsum("ij,tjd->tid", lt, xg).to(torch.bfloat16)
    return quant_acts_i8_ref(z.reshape(t, k), clip, q_max)


def left_quant_i8_flat(left_t, x, clip=None, q_max: int = 7):
    """(codes [T, K] int8, scales [T, 1] f32) = quant(left_t mixing of
    the G column groups of x). left_t [G, G] left-multiplies the grouped
    view (a Kronecker left factor's transpose, or o_t.T for the attention
    output's head mixing); x [T, K], K = G * 128. CUDA tensors launch
    the kernel (x bf16, G <= 128) or raise; CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return left_quant_i8_flat_ref(left_t, x, clip, q_max)
    t, k = x.shape
    g = k // 128
    req = common.require
    req(left_t.device == x.device, _LQ,
        "all inputs must be on the same CUDA device")
    req(x.dtype == torch.bfloat16, _LQ,
        f"x dtype {x.dtype} must be bfloat16 (the fused routes' dtype)")
    req(k % 128 == 0 and 0 < g <= 128 and tuple(left_t.shape) == (g, g),
        _LQ, f"shapes left_t {tuple(left_t.shape)}, x {tuple(x.shape)}")
    x = x.contiguous()
    req(x.data_ptr() % 16 == 0, _LQ, "x must be 16-byte aligned (TMA)")
    lt = left_t.to(torch.bfloat16).contiguous()  # wgmma's A, as JAX casts it
    cl = common.clip_vector([clip], x.device)
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    rc = common.lib(_LIB).fq_left_quant_i8_flat(
        lt.data_ptr(), x.data_ptr(), cl.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), t, g, float(q_max), common.stream_ptr(x))
    common.check(_LIB, _LQ, rc)
    common.LAUNCHES[_LQ] += 1
    return xq, xs


# ---------------------------------------------------------------------------
# merged up||gate W4A4 GEMM + SwiGLU + Kronecker right factor
# ---------------------------------------------------------------------------


def w4a4_matmul_i8_swiglu_right_ref(x_q, x_scale, w_packed, w_scale, right):
    """Plain version: act = w4a4_matmul_i8_swiglu's plain version in bf16
    (u, g dequantized from exact float32 products of integer codes, then
    bf16(u * (g * (1 / (1 + exp(-g)))))); returns act @ bf16(right) per
    128-column group -> bf16 [M, nh]."""
    act = w4a4_matmul_i8_swiglu_ref(x_q, x_scale, w_packed, w_scale,
                                    torch.bfloat16)
    return _group_right(act, right)


def w4a4_matmul_i8_swiglu_right(x_q, x_scale, w_packed, w_scale, right):
    """act[M, nh] = group-right(silu(deq(x @ gate^T)) * deq(x @ up^T)).

    x_q int8 [M, K]; x_scale f32 [M, 1]; w_packed uint8 [2*nh, K/2]
    planar (rows [0, nh) up, [nh, 2nh) gate); w_scale f32 [2*nh];
    right [128, 128]. Returns bf16 [M, nh]. CUDA tensors launch the kernel
    (nh % 128 == 0, K % 128 == 0) or raise; CPU tensors run the plain
    version."""
    if x_q.device.type == "cpu":
        return w4a4_matmul_i8_swiglu_right_ref(x_q, x_scale, w_packed,
                                               w_scale, right)
    m, k = x_q.shape
    n2 = w_packed.shape[0]
    nh = n2 // 2
    req = common.require
    req(all(t.device == x_q.device
            for t in (x_scale, w_packed, w_scale, right)), _SWI,
        "all inputs must be on the same CUDA device")
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _SWI, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n2, k // 2) and n2 % 256 == 0
        and k % 128 == 0 and x_scale.numel() == m and w_scale.numel() == n2
        and tuple(right.shape) == (128, 128), _SWI,
        f"shapes x_q {tuple(x_q.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}, "
        f"right {tuple(right.shape)}")
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    rf = right.to(torch.bfloat16).to(torch.float32).contiguous()
    y = torch.empty((m, nh), dtype=torch.bfloat16, device=x_q.device)
    rc = common.lib(_LIB).fq_w4a4_matmul_i8_swiglu_right(
        x_q.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), rf.data_ptr(), y.data_ptr(), m, nh, k,
        common.stream_ptr(x_q))
    common.check(_LIB, _SWI, rc)
    common.LAUNCHES[_SWI] += 1
    return y
