"""Grouped-layout transform + quant pipeline (port of
flatquant_tpu/kernels/grouped_mlp.py).

The JAX package's round-2 prefill kept the activations between its fused
kernels in the grouped layout [G, T, 128]: group g holds the columns
[g * 128, (g + 1) * 128) of the flat [T, G * 128] tensor, so the
Kronecker left factor is one plain [G, G] product over the leading axis.
Its serving engine moved to the flat layout (kernels/flat_pipeline.py)
after device profiling; these six functions stay as measured baselines:

    rmsnorm_right_grouped     row 4 (rmsnorm_right_flat), grouped output
    left_quant_i8_grouped     row 5 (left_quant_i8_flat), grouped in and out
    quant_acts_i8_grouped     row 12 (quant_acts_i8), grouped in and out
    w4a4_matmul_i8_grouped    row 1 (w4a4_matmul_i8), grouped input
    w4a4_swiglu_grouped       row 6 (w4a4_matmul_i8_swiglu_right), grouped
                              output
    w4a4_swiglu_grouped_gx    the same with grouped input

Each computes its flat twin's function on another address map, and each
plain version (`*_ref`) is the twin's plain version through the layout
glue (`group_layout`, `ungroup_layout`), so it rounds at the twin's points
(bf16 after u * silu(g), after each right product, after the left product
and after RMSNorm x w; IEEE division; extrema over bf16 values). The CUDA
kernels are the twins' device bodies with a layout flag
(csrc/flat_pipeline.cu, csrc/int4_matmul.cu), so on the card a grouped
kernel equals its twin bit for bit on the same values.

Each wrapper launches its CUDA kernel for CUDA tensors, or raises, and
runs its plain version for CPU tensors. JAX's block_m / block_n / block_t
and interpret arguments are TPU tiling knobs and have no counterpart.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common, int4_matmul
from flatquant_torch.kernels.flat_pipeline import (
    launch_rmsnorm_right,
    left_quant_i8_flat_ref,
    rmsnorm_right_flat_ref,
    w4a4_matmul_i8_swiglu_right_ref,
)
from flatquant_torch.kernels.int4_matmul import (
    quant_acts_i8_ref,
    w4a8_matmul_ref,
)

_SWI = "w4a4_swiglu_grouped"
_LQ = "left_quant_i8_grouped"
_QA = "quant_acts_i8_grouped"
_GEMM = "w4a4_matmul_i8_grouped"
_RMS = "rmsnorm_right_grouped"
_SWIGX = "w4a4_swiglu_grouped_gx"


def group_layout(x2d, n_groups: int):
    """[T, G*128] -> [G, T, 128], contiguous."""
    t = x2d.shape[0]
    return x2d.reshape(t, n_groups, 128).permute(1, 0, 2).contiguous()


def ungroup_layout(xg):
    """[G, T, 128] -> [T, G*128], contiguous."""
    g, t, _ = xg.shape
    return xg.permute(1, 0, 2).reshape(t, g * 128)


def _same_device(name, *tensors):
    common.require(all(t.device == tensors[0].device for t in tensors), name,
                   "all inputs must be on the same CUDA device")


def _swiglu_args(name, x_q, x_scale, w_packed, w_scale, right, m, k):
    req = common.require
    _same_device(name, x_q, x_scale, w_packed, w_scale, right)
    n2 = w_packed.shape[0]
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        name, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n2, k // 2) and n2 % 256 == 0
        and k % 128 == 0 and x_scale.numel() == m and w_scale.numel() == n2
        and tuple(right.shape) == (128, 128), name,
        f"shapes x_q {tuple(x_q.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}, "
        f"right {tuple(right.shape)}")


def _launch_swiglu(name, x_q, x_scale, w_packed, w_scale, right, m, k,
                   x_grouped):
    _swiglu_args(name, x_q, x_scale, w_packed, w_scale, right, m, k)
    nh = w_packed.shape[0] // 2
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    rf = right.to(torch.bfloat16).to(torch.float32).contiguous()
    y = torch.empty((nh // 128, m, 128), dtype=torch.bfloat16,
                    device=x_q.device)
    rc = common.lib("flat_pipeline").fq_w4a4_swiglu_grouped(
        x_q.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), rf.data_ptr(), y.data_ptr(), m, nh, k,
        int(x_grouped), common.stream_ptr(x_q))
    common.check("flat_pipeline", name, rc)
    common.LAUNCHES[name] += 1
    return y


# ---------------------------------------------------------------------------
# row 22: merged up||gate W4A4 GEMM + SwiGLU + right factor, grouped output
# ---------------------------------------------------------------------------


def w4a4_swiglu_grouped_ref(x_q, x_scale, w_packed, w_scale, right):
    """Plain version: w4a4_matmul_i8_swiglu_right's plain version, grouped
    -> bf16 [nh/128, M, 128]."""
    y = w4a4_matmul_i8_swiglu_right_ref(x_q, x_scale, w_packed, w_scale,
                                        right)
    return group_layout(y, y.shape[1] // 128)


def w4a4_swiglu_grouped(x_q, x_scale, w_packed, w_scale, right):
    """Y[nh/128, M, 128] = group-right(silu(deq(x @ gate^T)) *
    deq(x @ up^T)) in the grouped layout.

    x_q int8 [M, K]; x_scale f32 [M, 1]; w_packed uint8 [2*nh, K/2] planar
    (rows [0, nh) up, [nh, 2nh) gate); w_scale f32 [2*nh]; right
    [128, 128]. CUDA tensors launch the kernel (nh % 128 == 0, K % 128 ==
    0) or raise; CPU tensors run the plain version."""
    if x_q.device.type == "cpu":
        return w4a4_swiglu_grouped_ref(x_q, x_scale, w_packed, w_scale,
                                       right)
    m, k = x_q.shape
    return _launch_swiglu(_SWI, x_q, x_scale, w_packed, w_scale, right, m, k,
                          False)


# ---------------------------------------------------------------------------
# row 27: row 22 with grouped int8 input
# ---------------------------------------------------------------------------


def w4a4_swiglu_grouped_gx_ref(x_qg, x_scale, w_packed, w_scale, right):
    """Plain version: row 22's on ungroup_layout(x_qg)."""
    return w4a4_swiglu_grouped_ref(ungroup_layout(x_qg), x_scale, w_packed,
                                   w_scale, right)


def w4a4_swiglu_grouped_gx(x_qg, x_scale, w_packed, w_scale, right):
    """w4a4_swiglu_grouped with grouped int8 codes x_qg [Gin, M, 128]
    (left_quant_i8_grouped's output) in place of flat [M, K], K = Gin *
    128. CUDA tensors launch the kernel or raise; CPU tensors run the
    plain version."""
    if x_qg.device.type == "cpu":
        return w4a4_swiglu_grouped_gx_ref(x_qg, x_scale, w_packed, w_scale,
                                          right)
    gin, m, lw = x_qg.shape
    common.require(lw == 128, _SWIGX, f"x_qg shape {tuple(x_qg.shape)} "
                   "must be [Gin, M, 128]")
    return _launch_swiglu(_SWIGX, x_qg, x_scale, w_packed, w_scale, right,
                          m, gin * 128, True)


# ---------------------------------------------------------------------------
# row 23: left Kronecker factor + per-token quant, grouped in and out
# ---------------------------------------------------------------------------


def left_quant_i8_grouped_ref(left_t, x, clip=None, q_max: int = 7):
    """Plain version: left_quant_i8_flat's plain version through the
    layout glue -> (int8 [G, T, 128], f32 [T, 1])."""
    g = x.shape[0]
    q, s = left_quant_i8_flat_ref(left_t, ungroup_layout(x), clip, q_max)
    return group_layout(q, g), s


def left_quant_i8_grouped(left_t, x, clip=None, q_max: int = 7):
    """(codes [G, T, 128] int8, scales [T, 1] f32) = per-token quant of
    z = left_t @ x over the group axis. left_t [G, G] (the transposed
    left factor: pass left.T); x bf16 [G, T, 128]; clip the (cmax, cmin)
    LAC ratios or None. CUDA tensors launch the kernel (G <= 128) or
    raise; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return left_quant_i8_grouped_ref(left_t, x, clip, q_max)
    g, t, lw = x.shape
    req = common.require
    _same_device(_LQ, left_t, x)
    req(x.dtype == torch.bfloat16, _LQ, f"x dtype {x.dtype} must be bfloat16")
    req(lw == 128 and 0 < g <= 128 and tuple(left_t.shape) == (g, g), _LQ,
        f"shapes left_t {tuple(left_t.shape)}, x {tuple(x.shape)}")
    x = x.contiguous()
    req(x.data_ptr() % 16 == 0, _LQ, "x must be 16-byte aligned (TMA)")
    lt = left_t.to(torch.bfloat16).contiguous()  # wgmma's A, as JAX casts it
    cl = common.clip_vector([clip], x.device)
    xq = torch.empty((g, t, 128), dtype=torch.int8, device=x.device)
    xs = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    rc = common.lib("flat_pipeline").fq_left_quant_i8_grouped(
        lt.data_ptr(), x.data_ptr(), cl.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), t, g, float(q_max), common.stream_ptr(x))
    common.check("flat_pipeline", _LQ, rc)
    common.LAUNCHES[_LQ] += 1
    return xq, xs


# ---------------------------------------------------------------------------
# row 24: one-pass per-token quant, grouped in and out
# ---------------------------------------------------------------------------


def quant_acts_i8_grouped_ref(x, clip=None, q_max: int = 7):
    """Plain version: quant_acts_i8's plain version through the layout
    glue -> (int8 [G, T, 128], f32 [T, 1])."""
    g = x.shape[0]
    q, s = quant_acts_i8_ref(ungroup_layout(x), clip, q_max)
    return group_layout(q, g), s


def quant_acts_i8_grouped(x, clip=None, q_max: int = 7):
    """Per-token symmetric quant of x [G, T, 128] (bf16 or f32), token t's
    row being the concatenation over g of x[g, t, :]: (int8 codes
    [G, T, 128], f32 scales [T, 1]). CUDA tensors launch the kernel or
    raise; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return quant_acts_i8_grouped_ref(x, clip, q_max)
    g, t, lw = x.shape
    req = common.require
    req(x.dtype in (torch.bfloat16, torch.float32), _QA,
        f"x dtype {x.dtype} must be bfloat16 or float32")
    req(lw == 128, _QA, f"x shape {tuple(x.shape)} must be [G, T, 128]")
    x = x.contiguous()
    cl = common.clip_vector([clip], x.device)
    xq = torch.empty((g, t, 128), dtype=torch.int8, device=x.device)
    xs = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    rc = common.lib("int4_matmul").fq_quant_acts_i8_grouped(
        x.data_ptr(), cl.data_ptr(), xq.data_ptr(), xs.data_ptr(), t,
        g * 128, float(q_max), int(x.dtype == torch.float32),
        common.stream_ptr(x))
    common.check("int4_matmul", _QA, rc)
    common.LAUNCHES[_QA] += 1
    return xq, xs


# ---------------------------------------------------------------------------
# row 25: W4A4 GEMM on grouped int8 input
# ---------------------------------------------------------------------------


def w4a4_matmul_i8_grouped_ref(x_q, x_scale, w_packed, w_scale,
                               out_dtype=torch.bfloat16):
    """Plain version: w4a4_matmul_i8's (w4a8_matmul_ref) on
    ungroup_layout(x_q)."""
    return w4a8_matmul_ref(ungroup_layout(x_q), x_scale, w_packed, w_scale,
                           out_dtype)


def w4a4_matmul_i8_grouped(x_q, x_scale, w_packed, w_scale,
                           out_dtype=torch.bfloat16):
    """y[M, N] = dequant(ungroup_layout(x_q) @ unpack(w_packed)^T): row 1
    on grouped codes x_q int8 [G, M, 128], bit-identical to
    w4a4_matmul_i8 on the flat codes. x_scale f32 [M, 1]; w_packed uint8
    [N, G*64] planar; w_scale f32 [N]. Output bf16 or f32. CUDA tensors
    launch the body int4_matmul.w4a4_body picks, row 1's with the grouped
    address map (or raise); CPU tensors run the plain version."""
    if x_q.device.type == "cpu":
        return w4a4_matmul_i8_grouped_ref(x_q, x_scale, w_packed, w_scale,
                                          out_dtype)
    g, m, lw = x_q.shape
    k = g * 128
    n = w_packed.shape[0]
    req = common.require
    _same_device(_GEMM, x_q, x_scale, w_packed, w_scale)
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _GEMM, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(lw == 128 and tuple(w_packed.shape) == (n, k // 2)
        and x_scale.numel() == m and w_scale.numel() == n, _GEMM,
        f"shapes x_q {tuple(x_q.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    req(out_dtype in (torch.bfloat16, torch.float32), _GEMM,
        f"out_dtype {out_dtype} must be bfloat16 or float32")
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    req(x_q.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _GEMM,
        "x_q and w_packed must be 16-byte aligned")
    return int4_matmul.launch_w4a4(_GEMM, x_q, x_scale, w_packed, w_scale,
                                   out_dtype, m, n, k, grouped=True)


# ---------------------------------------------------------------------------
# row 26: RMSNorm + Kronecker right factor, grouped output
# ---------------------------------------------------------------------------


def rmsnorm_right_grouped_ref(x, w, right, eps: float):
    """Plain version: rmsnorm_right_flat's plain version, grouped ->
    bf16 [H/128, T, 128]."""
    return group_layout(rmsnorm_right_flat_ref(x, w, right, eps),
                        x.shape[1] // 128)


def rmsnorm_right_grouped(x, w, right, eps: float):
    """RMSNorm(x) * w, then the Kronecker right factor per 128-column
    group, in the grouped layout. x [T, H] bf16 or f32, H % 128 == 0; w
    [H]; right [128, 128]. Returns bf16 [H/128, T, 128]. CUDA tensors
    launch the kernel (row 4's body) or raise; CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return rmsnorm_right_grouped_ref(x, w, right, eps)
    return launch_rmsnorm_right(_RMS, x, w, right, eps, grouped=True)
