"""The int4-weight GEMMs of the serving linears and the one-pass
per-token activation quant (port of flatquant_tpu/kernels/int4_matmul.py,
the serving path's functions).

Weights are packed two int4 codes per byte in the planar layout shared
with the JAX package: byte c of row n = (q[n, c] + 8) | (q[n, c + K/2] + 8)
<< 4. The biased nibbles feed the products directly and the -8 zero
point folds into the epilogue as -8 * rowsum(x).

Kernels (each wrapper launches its CUDA kernel for CUDA tensors, or
raises, and runs its plain version for CPU tensors):

    w4a4_matmul_i8         int8 codes x int4 weights   (csrc/int4_matmul.cu;
                           two bodies, w4a4_body picks: a dp4a weight
                           stream below TILE_MIN_M rows, tensor-core
                           tiles from there on)
                           plain: w4a8_matmul_ref
    quant_acts_i8          per-token symmetric quant   (csrc/int4_matmul.cu)
                           plain: quant_acts_i8_ref
    w4a8_matmul            bf16 activations x int4     (csrc/int4_matmul.cu;
                           weights, float32 sums        two bodies, w4a8_body
                                                        picks: a weight stream
                                                        at decode, a wgmma
                                                        tile at prefill)
                           plain: w4a8_matmul_rowsum_ref
    w4a4_matmul_i8_swiglu  merged up||gate W4A4 GEMM   (csrc/flat_pipeline.cu,
                           with u * silu(g) in its      row 6's main loop)
                           float32 epilogue
                           plain: w4a4_matmul_i8_swiglu_ref
    w4a4_matmul_i8_fusedq  quant_acts_i8 (q_max 7)      (csrc/int4_matmul.cu;
                           fused into w4a4_matmul_i8,   two bodies,
                           bit for bit                  fusedq_body picks)
                           plain: w4a4_matmul_i8_fusedq_ref

`w4a8_matmul_ref` is also JAX's pure-XLA reference of w4a8_matmul
(x @ (nib - 8)^T in float32), which the engine calls with
use_kernel=False, as JAX's does.
"""

from __future__ import annotations

import torch

from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels import common

_NAME = "w4a4_matmul_i8"
# The smallest M at which row 1's tensor-core tile body is faster than its
# dp4a weight stream at all four llama-2-7b shapes (chip_smoke.py phase
# 3a's sweep on an H100; PERF.md gives the times).
TILE_MIN_M = 32
# The tile body sums 16 * (nibble - 8) products in int32: exact for any
# int8 codes below this K (128 * 128 * K < 2^31).
TILE_MAX_K = 1 << 17
# Row 17 takes the tile from FUSEDQ_WIDE_MIN_M rows already when the weight
# has at least FUSEDQ_WIDE_N rows: at M = 16 phase 3a measured the tile
# faster than the dp4a body at every N it sweeps from 5120 to 22016 (K =
# 4096), and slower at N = 4096 (o, down), whose 32 weight tiles are too
# few blocks to pull the weight.
FUSEDQ_WIDE_MIN_M = 16
FUSEDQ_WIDE_N = 5120
# From FUSEDQ_WAVE_MIN_M rows it takes the tile for a weight of
# FUSEDQ_WAVE_N[0] to FUSEDQ_WAVE_N[1] rows: one wave of the tile's 128-row
# weight blocks on the H100's 132 SMs, so the tile costs what it costs at
# one row while the dp4a body grows with M. At M = 4 phase 3a measured the
# tile 1.5-3.9% faster on qkv's 12288 rows (96 blocks) in five runs, and
# slower on up||gate's 22016 (172 blocks, two waves) and on 4096 rows.
FUSEDQ_WAVE_MIN_M = 4
FUSEDQ_WAVE_N = (12288, 132 * 128)
# Row 14 (w4a8_matmul) streams the weight on the CUDA cores up to
# W4A8_STREAM_MAX_M rows (decode) and takes its wgmma tile above
# (prefill), or from W4A8_WIDE_MIN_M rows already for a weight of at least
# W4A8_WIDE_N rows: chip_smoke.py phase 3g's sweep on an H100 measured
# the tile faster at M = 16 for all four llama-2-7b linears and at M = 8
# for its qkv and up||gate (12288, 22016 rows; the stream at M = 4), and
# slower at M = 8 for its o and down (4096 rows).
W4A8_STREAM_MAX_M = 8
W4A8_WIDE_MIN_M = 8
W4A8_WIDE_N = 12288
# row 14's device bodies, each an entry point fq_w4a8_matmul_<body>
W4A8_BODIES = ("stream", "tile")
_QA = "quant_acts_i8"
_W4A8 = "w4a8_matmul"
_SWI = "w4a4_matmul_i8_swiglu"
_FUSEDQ = "w4a4_matmul_i8_fusedq"


def pack_weight_planar(q: torch.Tensor) -> torch.Tensor:
    """int8 codes [N, K] in [-8, 7] -> planar biased uint8 [N, K/2]."""
    n, k = q.shape
    if k % 2:
        raise ValueError(f"K={k} must be even")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return u[:, : k // 2] | (u[:, k // 2:] << 4)


def unpack_weight_planar(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_weight_planar -> int8 [N, K]."""
    lo = (wp & 0xF).to(torch.int16) - 8
    hi = ((wp >> 4) & 0xF).to(torch.int16) - 8
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def w4a8_matmul_ref(x_q, x_scale, w_packed, w_scale,
                    out_dtype=torch.bfloat16):
    """Plain version of w4a4_matmul_i8, and JAX's w4a8_matmul_ref:
    y = (x_q @ unpack(w)^T) * x_scale * w_scale in float32.

    For integer codes the float32 product is exact (sums below 2^24), so
    with TF32 off this equals w4a4_matmul_i8's int32 accumulation bit for
    bit, and the epilogue multiplies in the same order."""
    w = unpack_weight_planar(w_packed).to(torch.float32)
    acc = x_q.to(torch.float32) @ w.T
    out = acc * x_scale.reshape(-1, 1) * w_scale.reshape(1, -1)
    return out.to(out_dtype)


def _on_device(name, *tensors):
    common.require(all(t.is_cuda and t.device == tensors[0].device
                       for t in tensors), name,
                   "all inputs must be on the same CUDA device")


def _out_dtype(name, out_dtype):
    common.require(out_dtype in (torch.bfloat16, torch.float32), name,
                   f"out_dtype {out_dtype} must be bfloat16 or float32")


def w4a4_body(m: int, n: int, k: int) -> str:
    """The device body of w4a4_matmul_i8 and w4a4_matmul_i8_grouped for an
    [M, K] x [N, K]^T product: "tile" (tensor cores) from TILE_MIN_M rows
    on, else "stream" (the dp4a weight stream, the decode body). N does not
    move it: the tile masks a ragged N. Nor does K below TILE_MAX_K: the
    tile zero-fills the activations past K/2, so a K % 64 == 32 (a last
    stage of 16 packed bytes) takes the same rule as any K % 32 == 0."""
    return "tile" if m >= TILE_MIN_M and k < TILE_MAX_K else "stream"


def launch_w4a4(name, x_q, x_scale, w_packed, w_scale, out_dtype, m, n, k,
                grouped):
    """Launch the body that w4a4_body picks for row 1 (x_q [M, K]) or, with
    grouped, row 25 (x_q [K/128, M, 128]) on checked, contiguous CUDA
    tensors; raise if the launch fails (no other body is tried). Counted
    under `name` and, by body, in common.BODY_LAUNCHES."""
    body = w4a4_body(m, n, k)
    y = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = getattr(common.lib("int4_matmul"),
                 f"fq_w4a4_matmul_i8{'_grouped' if grouped else ''}_{body}")
    rc = fn(x_q.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), y.data_ptr(), m, n, k,
            int(out_dtype == torch.float32), common.stream_ptr(x_q))
    common.check("int4_matmul", name, rc)
    common.LAUNCHES[name] += 1
    common.BODY_LAUNCHES[name][body] += 1
    return y


def w4a4_matmul_i8(x_q, x_scale, w_packed, w_scale,
                   out_dtype=torch.bfloat16):
    """y[M, N] = dequant(x_q[M, K] @ unpack(w_packed)[N, K]^T).

    x_q int8 codes [M, K] on the int4 grid; x_scale f32 [M, 1]; w_packed
    uint8 [N, K/2] planar; w_scale f32 [N]. Output bf16 or f32.
    CUDA tensors launch the body w4a4_body picks (or raise); CPU tensors
    run w4a8_matmul_ref."""
    if x_q.device.type == "cpu":
        return w4a8_matmul_ref(x_q, x_scale, w_packed, w_scale, out_dtype)
    m, k = x_q.shape
    n = w_packed.shape[0]
    req = common.require
    _on_device(_NAME, x_q, x_scale, w_packed, w_scale)
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _NAME, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n, k // 2) and x_scale.numel() == m
        and w_scale.numel() == n, _NAME,
        f"shapes x_q {tuple(x_q.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    req(k % 32 == 0, _NAME, f"K={k} must be a multiple of 32")
    _out_dtype(_NAME, out_dtype)
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    req(x_q.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _NAME,
        "x_q and w_packed must be 16-byte aligned")
    return launch_w4a4(_NAME, x_q, x_scale, w_packed, w_scale, out_dtype, m,
                       n, k, grouped=False)


# ---------------------------------------------------------------------------
# one-pass per-token activation quant
# ---------------------------------------------------------------------------


def quant_acts_i8_ref(x, clip=None, q_max: int = 7, extrema=None):
    """Plain version (the serving engine's per-token quant chain, JAX's
    `_act_codes_i8`): (int8 codes [T, K], f32 scales [T, 1]).

    xmax/xmin clip separately by their LAC ratios, absmax = max(|xmin|,
    xmax), scale = absmax / q_max (1 for an all-zero row), codes =
    clamp(round(x / scale), -q_max-1, q_max) with round half to even.
    extrema: a function (xmax, xmin) -> (xmax, xmin) applied to the row
    extrema before the clip (tensor parallelism reduces them over the
    ranks that hold the row's other channels)."""
    xf = x.to(torch.float32)
    xmax = torch.clamp(xf.amax(dim=-1, keepdim=True), min=0.0)
    xmin = torch.clamp(xf.amin(dim=-1, keepdim=True), max=0.0)
    if extrema is not None:
        xmax, xmin = extrema(xmax, xmin)
    if clip is not None:
        xmax = xmax * clip[0]
        xmin = xmin * clip[1]
    absmax = torch.maximum(xmin.abs(), xmax)
    xs = torch.where(absmax == 0, 1.0, true_div(absmax, q_max))
    xq = torch.clamp(torch.round(xf / xs), -q_max - 1, q_max)
    return xq.to(torch.int8), xs


def quantize_acts_sym(x, q_max: int = 7, clip_max=None):
    """Per-token symmetric quant on the [-q_max-1, q_max] grid, JAX's plain
    helper (deploy/nn/quantization.py:5-44): scale = absmax / q_max (1 for
    an all-zero row), absmax times sigmoid(clip_max) when a LAC factor is
    given. Returns (codes as bf16, exact small integers; float32 scales
    [T, 1])."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if clip_max is not None:
        absmax = absmax * torch.sigmoid(torch.as_tensor(
            clip_max, device=xf.device))
    scale = torch.where(absmax == 0, 1.0, true_div(absmax, q_max))
    q = torch.clamp(torch.round(xf / scale), -q_max - 1, q_max)
    return q.to(torch.bfloat16), scale


def quant_acts_i8(x, clip=None, q_max: int = 7):
    """Per-token symmetric quant of x [M, K] (bf16 or f32, K % 128 == 0)
    in one read of x: (int8 codes [M, K], f32 scales [M, 1]). clip: the
    (rmax, rmin) LAC ratios, or None. CUDA tensors launch the kernel (or
    raise); CPU tensors run quant_acts_i8_ref."""
    if x.device.type == "cpu":
        return quant_acts_i8_ref(x, clip, q_max)
    m, k = x.shape
    req = common.require
    _on_device(_QA, x)
    req(x.dtype in (torch.bfloat16, torch.float32), _QA,
        f"x dtype {x.dtype} must be bfloat16 or float32")
    req(k % 128 == 0, _QA, f"K={k} must be a multiple of 128")
    x = x.contiguous()
    cl = common.clip_vector([clip], x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = common.lib("int4_matmul").fq_quant_acts_i8(
        x.data_ptr(), cl.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
        float(q_max), int(x.dtype == torch.float32), common.stream_ptr(x))
    common.check("int4_matmul", _QA, rc)
    common.LAUNCHES[_QA] += 1
    return xq, xs


# ---------------------------------------------------------------------------
# bf16 activations x int4 weights (weight-only W4A16 linears)
# ---------------------------------------------------------------------------


def w4a8_matmul_rowsum_ref(x, x_scale, w_packed, w_scale,
                           out_dtype=torch.bfloat16):
    """Plain version of w4a8_matmul, in the kernel's algebra: acc = x @
    nib^T over the biased nibbles (0..15) and rowsum = sum(x), both in
    float32; y = (acc - 8 * rowsum) * x_scale * w_scale. It equals
    w4a8_matmul_ref's x @ (nib - 8)^T up to float32 rounding."""
    nib = torch.cat([w_packed & 0xF, w_packed >> 4], dim=1).to(torch.float32)
    xf = x.to(torch.float32)
    acc = xf @ nib.T
    rowsum = xf.sum(dim=-1, keepdim=True)
    out = ((acc - 8.0 * rowsum) * x_scale.reshape(-1, 1)
           * w_scale.reshape(1, -1))
    return out.to(out_dtype)


def w4a8_body(m: int, n: int) -> str:
    """The device body of w4a8_matmul for an [M, K] x [N, K]^T product:
    "tile" (the wgmma bf16 tile) above W4A8_STREAM_MAX_M rows, or from
    W4A8_WIDE_MIN_M rows for N >= W4A8_WIDE_N; else "stream" (the weight
    stream, float32 FMAs on the CUDA cores, the decode body)."""
    wide = m >= W4A8_WIDE_MIN_M and n >= W4A8_WIDE_N
    return "tile" if m > W4A8_STREAM_MAX_M or wide else "stream"


def launch_w4a8(x, x_scale, w_packed, w_scale, out_dtype, m, n, k):
    """Launch the body that w4a8_body picks on checked, contiguous CUDA
    tensors; raise if the launch fails (no other body is tried). Counted
    under LAUNCHES and, by body, BODY_LAUNCHES."""
    body = w4a8_body(m, n)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = getattr(common.lib("int4_matmul"), f"fq_w4a8_matmul_{body}")(
        x.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), m, n, k,
        int(out_dtype == torch.float32), common.stream_ptr(x))
    common.check("int4_matmul", _W4A8, rc)
    common.LAUNCHES[_W4A8] += 1
    common.BODY_LAUNCHES[_W4A8][body] += 1
    return y


def w4a8_matmul(x, x_scale, w_packed, w_scale, out_dtype=torch.bfloat16):
    """y[M, N] = (x @ nib^T - 8 * rowsum(x)) * x_scale * w_scale.

    x bf16 activations [M, K] (any values, not codes); x_scale f32 [M, 1]
    (ones for weight-only serving); w_packed uint8 [N, K/2] planar;
    w_scale f32 [N]. Output bf16 or f32. CUDA tensors launch the body
    w4a8_body picks (K % 64 == 0) or raise; CPU tensors run
    w4a8_matmul_rowsum_ref."""
    if x.device.type == "cpu":
        return w4a8_matmul_rowsum_ref(x, x_scale, w_packed, w_scale,
                                      out_dtype)
    m, k = x.shape
    n = w_packed.shape[0]
    req = common.require
    _on_device(_W4A8, x, x_scale, w_packed, w_scale)
    req(x.dtype == torch.bfloat16 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _W4A8, "dtypes must be x bfloat16, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n, k // 2) and x_scale.numel() == m
        and w_scale.numel() == n, _W4A8,
        f"shapes x {tuple(x.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    req(k % 64 == 0 and k > 0, _W4A8, f"K={k} must be a positive multiple "
        "of 64")
    _out_dtype(_W4A8, out_dtype)
    x, w_packed = x.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    req(x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _W4A8,
        "x and w_packed must be 16-byte aligned")
    return launch_w4a8(x, x_scale, w_packed, w_scale, out_dtype, m, n, k)


# ---------------------------------------------------------------------------
# merged up||gate W4A4 GEMM with the SwiGLU in its epilogue
# ---------------------------------------------------------------------------


def w4a4_matmul_i8_swiglu_ref(x_q, x_scale, w_packed, w_scale,
                              out_dtype=torch.bfloat16):
    """Plain version, the kernel's float32 epilogue: u, g = dequant(x_q @
    w^T) for the up rows [0, nh) and the gate rows [nh, 2nh) (exact
    float32 products of integer codes, times x_scale then w_scale);
    out_dtype(u * (g * (1 / (1 + exp(-g))))), rounded once at the end.
    (The engine's composed route, silu(gate) * up on the rounded GEMM
    output, rounds after every op instead.)"""
    y = w4a8_matmul_ref(x_q, x_scale, w_packed, w_scale, torch.float32)
    u, g = y.chunk(2, dim=-1)
    # 1 / (1 + exp(-g)) as a tensor-by-tensor IEEE division, as the kernel
    # and JAX divide: `1.0 / t` runs torch's reciprocal kernel, which once
    # returned values up to 2^-14 off on the CPU (ROADMAP.md section 3)
    den = 1.0 + torch.exp(-g)
    return (u * (g * (torch.ones_like(den) / den))).to(out_dtype)


def w4a4_matmul_i8_swiglu(x_q, x_scale, w_packed, w_scale,
                          out_dtype=torch.bfloat16):
    """out[M, nh] = silu(deq(x @ gate^T)) * deq(x @ up^T), the SwiGLU in a
    float32 epilogue.

    x_q int8 [M, K]; x_scale f32 [M, 1]; w_packed uint8 [2*nh, K/2]
    planar (rows [0, nh) up, [nh, 2nh) gate); w_scale f32 [2*nh]. Output
    bf16 or f32. CUDA tensors launch the kernel (nh % 128 == 0, K % 64 ==
    0) or raise; CPU tensors run w4a4_matmul_i8_swiglu_ref."""
    if x_q.device.type == "cpu":
        return w4a4_matmul_i8_swiglu_ref(x_q, x_scale, w_packed, w_scale,
                                         out_dtype)
    m, k = x_q.shape
    n2 = w_packed.shape[0]
    nh = n2 // 2
    req = common.require
    _on_device(_SWI, x_q, x_scale, w_packed, w_scale)
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _SWI, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n2, k // 2) and n2 % 256 == 0
        and k % 64 == 0 and x_scale.numel() == m and w_scale.numel() == n2,
        _SWI, f"shapes x_q {tuple(x_q.shape)}, w_packed "
        f"{tuple(w_packed.shape)}, x_scale {tuple(x_scale.shape)}, w_scale "
        f"{tuple(w_scale.shape)} (nh % 128 == 0, K % 64 == 0)")
    _out_dtype(_SWI, out_dtype)
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    req(x_q.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _SWI,
        "x_q and w_packed must be 16-byte aligned")
    y = torch.empty((m, nh), dtype=out_dtype, device=x_q.device)
    rc = common.lib("flat_pipeline").fq_w4a4_matmul_i8_swiglu(
        x_q.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), m, nh, k,
        int(out_dtype == torch.float32), common.stream_ptr(x_q))
    common.check("flat_pipeline", _SWI, rc)
    common.LAUNCHES[_SWI] += 1
    return y


# ---------------------------------------------------------------------------
# per-token quant in the GEMM's prologue
# ---------------------------------------------------------------------------


def w4a4_matmul_i8_fusedq_ref(x, w_packed, w_scale, clip=None,
                              out_dtype=torch.bfloat16):
    """Plain version of w4a4_matmul_i8_fusedq: the composed route,
    quant_acts_i8_ref(x, clip, 7) then w4a8_matmul_ref."""
    xq, xs = quant_acts_i8_ref(x, clip, 7)
    return w4a8_matmul_ref(xq, xs, w_packed, w_scale, out_dtype)


def fusedq_body(m: int, n: int, k: int) -> str:
    """The device body of w4a4_matmul_i8_fusedq: "tile" (each 128-row M
    tile quantized once into a workspace, then row 1's tensor-core tile)
    from TILE_MIN_M rows on, from FUSEDQ_WIDE_MIN_M rows for a weight of
    at least FUSEDQ_WIDE_N rows, or from FUSEDQ_WAVE_MIN_M rows for one of
    FUSEDQ_WAVE_N rows, while K < TILE_MAX_K; else "stream" (quantized
    rows in shared memory, row 1's dp4a warp body)."""
    wide = m >= FUSEDQ_WIDE_MIN_M and n >= FUSEDQ_WIDE_N
    wave = (m >= FUSEDQ_WAVE_MIN_M
            and FUSEDQ_WAVE_N[0] <= n <= FUSEDQ_WAVE_N[1])
    return "tile" if (m >= TILE_MIN_M or wide or wave) and k < TILE_MAX_K \
        else "stream"


def fusedq_workspace(m: int, k: int, device):
    """The tile body's workspace: int8 codes [M, K], float32 scales [M]
    and two zeroed int32 flags (ticket, groups done) per 128-row M tile,
    made for every launch, so no state outlives one (CUDA-graph replays
    included: the zeroing is captured with the launch)."""
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m,), dtype=torch.float32, device=device),
            torch.zeros((2 * -(-m // 128),), dtype=torch.int32,
                        device=device))


def launch_fusedq(x, cl, w_packed, w_scale, out_dtype, m, n, k):
    """Launch the body that fusedq_body picks on checked, contiguous CUDA
    tensors; raise if the launch fails (no other body is tried). Counted
    under LAUNCHES and, by body, BODY_LAUNCHES."""
    body = fusedq_body(m, n, k)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    types = (int(x.dtype == torch.float32), int(out_dtype == torch.float32))
    stream = common.stream_ptr(x)
    lib = common.lib("int4_matmul")
    if body == "tile":
        xq, xs, tickets = fusedq_workspace(m, k, x.device)
        rc = lib.fq_w4a4_matmul_i8_fusedq_tile(
            x.data_ptr(), cl.data_ptr(), w_packed.data_ptr(),
            w_scale.data_ptr(), y.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            tickets.data_ptr(), m, n, k, *types, stream)
    else:
        rc = lib.fq_w4a4_matmul_i8_fusedq_stream(
            x.data_ptr(), cl.data_ptr(), w_packed.data_ptr(),
            w_scale.data_ptr(), y.data_ptr(), m, n, k, *types, stream)
    common.check("int4_matmul", _FUSEDQ, rc)
    common.LAUNCHES[_FUSEDQ] += 1
    common.BODY_LAUNCHES[_FUSEDQ][body] += 1
    return y


def w4a4_matmul_i8_fusedq(x, w_packed, w_scale, clip=None,
                          out_dtype=torch.bfloat16):
    """y[M, N] = w4a4_matmul_i8(quant_acts_i8(x, clip, 7), w_packed,
    w_scale) in one launch (JAX's w4a4_matmul_i8_fusedq,
    flatquant_tpu/kernels/int4_matmul.py:553), bit for bit.

    x bf16 or f32 activations [M, K] (not codes); w_packed uint8 [N, K/2]
    planar; w_scale f32 [N]; clip the (rmax, rmin) LAC ratios or None.
    Output bf16 or f32. CUDA tensors launch the body fusedq_body picks
    (K % 32 == 0; on the stream body a K whose rows of codes overflow the
    block's shared memory fails the launch) or raise; CPU tensors run
    w4a4_matmul_i8_fusedq_ref."""
    if x.device.type == "cpu":
        return w4a4_matmul_i8_fusedq_ref(x, w_packed, w_scale, clip,
                                         out_dtype)
    m, k = x.shape
    n = w_packed.shape[0]
    req = common.require
    _on_device(_FUSEDQ, x, w_packed, w_scale)
    req(x.dtype in (torch.bfloat16, torch.float32)
        and w_packed.dtype == torch.uint8 and w_scale.dtype == torch.float32,
        _FUSEDQ, "dtypes must be x bfloat16 or float32, w_packed uint8, "
        "w_scale float32")
    req(tuple(w_packed.shape) == (n, k // 2) and w_scale.numel() == n,
        _FUSEDQ, f"shapes x {tuple(x.shape)}, w_packed "
        f"{tuple(w_packed.shape)}, w_scale {tuple(w_scale.shape)}")
    req(k % 32 == 0 and k > 0, _FUSEDQ, f"K={k} must be a multiple of 32")
    _out_dtype(_FUSEDQ, out_dtype)
    x, w_packed, w_scale = (x.contiguous(), w_packed.contiguous(),
                            w_scale.contiguous())
    req(x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _FUSEDQ,
        "x and w_packed must be 16-byte aligned")
    return launch_fusedq(x, common.clip_vector([clip], x.device), w_packed,
                         w_scale, out_dtype, m, n, k)
