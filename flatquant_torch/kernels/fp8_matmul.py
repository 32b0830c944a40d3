"""FP8 block-scaled serving GEMM (port of flatquant_tpu/kernels/fp8_matmul.py):
float8_e4m3 weights with one float32 scale per [128, 128] block, bf16
activations, float32 sums.

    y[M, N] = sum_c se[c, n] * (x[:, c] @ decode(w8[n, c])^T)

over the 128-wide k-chunks c. The activations are never quantized: the
kernel decodes each e4m3 code into bf16, where it embeds exactly, and
multiplies on the bf16 tensor cores (wgmma, the weights as A from
registers, the tokens as N). Each chunk's partial sum starts from zero, is
scaled by its row's se[c, n] and added to the running float32 sums with an
IEEE add (csrc/fp8_matmul.cu).

Kernels (the wrapper launches its CUDA kernel for CUDA tensors, or
raises, and runs its plain version for CPU tensors):

    fp8_matmul   bf16 x [(E,) M, K] times e4m3 w8 [(E,) N, K] with
                 expanded scales se [(E,) K/128, N]; an optional leading
                 expert axis is one launch   (csrc/fp8_matmul.cu; three
                 bodies by the tokens a block takes, fp8_body picks)
                 plain: fp8_matmul_ref

`fp8_linear` dispatches as JAX's does: the kernel serves a 128-aligned K
packed in 128-blocks (any N: the kernel masks a ragged one); every other
weight takes `fp8_matmul_ref`, JAX's own XLA route for it (not a
fallback: JAX sends those shapes there on the TPU too).

Weights are torch.float8_e4m3fn; `fp8_block_quantize` gives the codes
ml_dtypes' cast gives (round to nearest even, out of range to NaN), with
subnormal codes flushed to zero unless ftz=False.
"""

from __future__ import annotations

import torch

from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels import common

BLOCK = 128
E4M3_MAX = 448.0
_NAME = "fp8_matmul"


# ---------------------------------------------------------------------------
# load-time helpers
# ---------------------------------------------------------------------------


def _to_e4m3(v: torch.Tensor) -> torch.Tensor:
    """float32 -> float8_e4m3fn codes as ml_dtypes casts: round to nearest
    even, and NaN where the rounded magnitude passes 448 (torch's own cast
    saturates those to 448)."""
    u = v.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (v.abs() > 464.0) | torch.isnan(v)
    sign = (v < 0).to(torch.uint8) << 7
    return torch.where(nan, sign | 0x7F, u).view(torch.float8_e4m3fn)


def fp8_block_quantize(w: torch.Tensor, block: int = BLOCK, ftz: bool = True):
    """Blockwise-symmetric fp8 quantization of w [..., N, K] -> (w8
    float8_e4m3fn [..., N, K], scales [..., ceil(N/b), ceil(K/b)] float32),
    scale = tile absmax / 448 (1 for an all-zero tile), codes = the e4m3
    cast of w / scale (a true division). ftz=True flushes subnormal codes
    (|value| < 2^-6) to +0, so the kernel's flush-to-zero decode is exact
    on the weights packed here."""
    *lead, n, k = w.shape
    sn, sk = -(-n // block), -(-k // block)
    wf = torch.nn.functional.pad(w.to(torch.float32),
                                 (0, sk * block - k, 0, sn * block - n))
    tiles = wf.reshape(*lead, sn, block, sk, block)
    absmax = tiles.abs().amax(dim=(-3, -1))
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         true_div(absmax, E4M3_MAX))
    q = _to_e4m3(tiles / scales[..., :, None, :, None])
    if ftz:
        u = q.view(torch.uint8)
        q = torch.where((u & 0x7F) < 8, torch.zeros_like(u), u).view(
            torch.float8_e4m3fn)
    w8 = q.reshape(*lead, sn * block, sk * block)[..., :n, :k].contiguous()
    return w8, scales


def expand_fp8_scales(scales: torch.Tensor, n: int, k: int,
                      block: int = BLOCK) -> torch.Tensor:
    """[..., ceil(N/b), ceil(K/b)] checkpoint scales -> the kernel's layout
    [..., ceil(K/b), N] float32: transposed and repeated along the output
    dim, then cut to N. A K that is not a multiple of b must fit one
    block (tiny fixtures)."""
    rows = -(-k // block)
    if not (k % block == 0 or rows == 1):
        raise ValueError(f"K={k} is neither a multiple of {block} nor "
                         "within one block")
    if tuple(scales.shape[-2:]) != (-(-n // block), rows):
        raise ValueError(f"scales {tuple(scales.shape)} do not tile "
                         f"[{n}, {k}] in blocks of {block}")
    s = scales.to(torch.float32).transpose(-1, -2)
    return s.repeat_interleave(block, dim=-1)[..., :n].contiguous()


def prep_fp8_weight(w: torch.Tensor, block: int = BLOCK) -> dict:
    """bf16/f32 weight [..., N, K] -> serving dict {"w8", "se"}. A block
    that does not divide both N and K halves until it does (the largest
    power-of-two common divisor); fp8_linear reads the block back from
    se's shape."""
    n, k = w.shape[-2:]
    b = block
    while n % b or k % b:
        b //= 2
    w8, scales = fp8_block_quantize(w, b)
    return {"w8": w8, "se": expand_fp8_scales(scales, n, k, b)}


def decode_e4m3(w8: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """The kernel's decode as a plain function, float32: exact=True the
    IEEE value of every non-NaN code; exact=False flushes the subnormal
    codes (0 < |value| < 2^-6) to +0."""
    v = w8.to(torch.float32)
    if exact:
        return v
    em = w8.view(torch.uint8) & 0x7F
    return torch.where(em < 8, torch.zeros_like(v), v)


# ---------------------------------------------------------------------------
# the GEMM
# ---------------------------------------------------------------------------


def fp8_matmul_ref(x, w8, se, out_dtype=torch.bfloat16, exact: bool = True):
    """Plain version (JAX's fp8_matmul_ref): x cast to bf16, each k-chunk's
    product in float32 (exact products of bf16 and e4m3 values, float32
    sums), scaled by se and summed over the chunks in float32. The chunk
    width is K / se.shape[-2], so blocks under 128 (tiny models) run here.
    x [..., M, K], w8 [..., N, K], se [..., K/b, N]: a leading expert axis
    is batched. exact=False decodes as the kernel's flush-to-zero mode
    (JAX's reference decodes exactly; both agree on ftz-packed weights)."""
    *lead, m, k = x.shape
    n = w8.shape[-2]
    nc = se.shape[-2]
    b = k // nc
    xc = x.to(torch.bfloat16).to(torch.float32).reshape(*lead, m, nc, b)
    wc = decode_e4m3(w8, exact).reshape(*lead, n, nc, b)
    parts = torch.einsum("...mck,...nck->...cmn", xc, wc)
    acc = torch.sum(parts * se.to(torch.float32)[..., :, None, :], dim=-3)
    return acc.to(out_dtype)


# the device bodies of fp8_matmul, named by the tokens (wgmma's N) one
# block takes, and the largest M each body is routed (n128 takes the rest)
BODY_NAMES = ("n8", "n64", "n128")
BODY_MAX_M = {"n8": 8, "n64": 64}


def fp8_body(m: int) -> str:
    """The device body of fp8_matmul for M tokens: "n8" (64 channels x 8
    tokens a block, the decode weight stream) up to 8 rows, "n64" (64 x
    64) up to 64, "n128" (128 x 128, the prefill tile) above. N and K do
    not move it: the bodies mask a ragged N, and K is whole chunks."""
    return next((b for b in BODY_NAMES[:-1] if m <= BODY_MAX_M[b]), "n128")


def fp8_matmul(x, w8, se, out_dtype=torch.bfloat16, exact: bool = False):
    """y[(E,) M, N] = x[(E,) M, K] @ (w8 * blockscale)[(E,) N, K]^T.

    x bf16 (float32 is cast to bf16, as JAX casts); w8 float8_e4m3fn;
    se float32 [(E,) K/128, N] (expand_fp8_scales); K % 128 == 0, any N.
    A leading expert axis on w8 and se (x may be broadcast over it:
    stride 0) runs in the same launch. exact=True decodes every code;
    exact=False (JAX's default) flushes subnormal codes to zero, exact on
    weights packed with fp8_block_quantize(ftz=True). Output bf16 or f32.
    CUDA tensors launch the body fp8_body picks (or raise: no other body
    is tried); CPU tensors run fp8_matmul_ref."""
    if x.device.type == "cpu":
        return fp8_matmul_ref(x, w8, se, out_dtype, exact)
    req = common.require
    req(x.is_cuda and w8.device == x.device and se.device == x.device,
        _NAME, "all inputs must be on the same CUDA device")
    req(w8.dtype == torch.float8_e4m3fn and se.dtype == torch.float32
        and x.dtype in (torch.bfloat16, torch.float32), _NAME,
        "dtypes must be x bfloat16 or float32, w8 float8_e4m3fn, se float32")
    req(out_dtype in (torch.bfloat16, torch.float32), _NAME,
        f"out_dtype {out_dtype} must be bfloat16 or float32")
    batched = w8.dim() == 3
    e = w8.shape[0] if batched else 1
    m, k = x.shape[-2:]
    n = w8.shape[-2]
    req(w8.dim() in (2, 3) and x.dim() == w8.dim() and se.dim() == w8.dim()
        and (not batched or (x.shape[0] == e and se.shape[0] == e)), _NAME,
        f"shapes x {tuple(x.shape)}, w8 {tuple(w8.shape)}, se "
        f"{tuple(se.shape)}: one leading expert axis on all three or none")
    req(w8.shape[-1] == k and k % BLOCK == 0
        and tuple(se.shape[-2:]) == (k // BLOCK, n), _NAME,
        f"K={k} must be a multiple of {BLOCK} with se [K/128, N], "
        f"got w8 {tuple(w8.shape)}, se {tuple(se.shape)}")
    x = x.to(torch.bfloat16)
    x_estride = 0
    if batched:
        # an expert-broadcast x (stride 0) is read once per expert in place
        if x.stride(0) == 0 and x[0].is_contiguous():
            x_estride = 0
        else:
            x = x.contiguous()
            x_estride = m * k
    else:
        x = x.contiguous()
    w8, se = w8.contiguous(), se.contiguous()
    req(x.data_ptr() % 16 == 0 and w8.data_ptr() % 16 == 0, _NAME,
        "x and w8 must be 16-byte aligned")
    return launch_fp8(x, x_estride, w8, se, out_dtype, exact,
                      e if batched else None, m, n, k)


def launch_fp8(x, x_estride, w8, se, out_dtype, exact, e, m, n, k):
    """Launch the body that fp8_body picks on checked, contiguous CUDA
    tensors (e: the expert count, None without the axis); raise if the
    launch fails (no other body is tried). Counted under LAUNCHES and, by
    body, BODY_LAUNCHES."""
    body = fp8_body(m)
    y = torch.empty(((e,) if e is not None else ()) + (m, n),
                    dtype=out_dtype, device=x.device)
    rc = getattr(common.lib("fp8_matmul"), f"fq_fp8_matmul_{body}")(
        x.data_ptr(), x_estride, w8.data_ptr(), se.data_ptr(), y.data_ptr(),
        e or 1, m, n, k, int(exact), int(out_dtype == torch.float32),
        common.stream_ptr(x))
    common.check("fp8_matmul", _NAME, rc)
    common.LAUNCHES[_NAME] += 1
    common.BODY_LAUNCHES[_NAME][body] += 1
    return y


def fp8_linear(x, lin: dict, out_dtype=None, use_kernel: bool = None,
               exact: bool = False):
    """Apply an fp8 serving linear {"w8" [(E,) N, K], "se"} to x [..., K]
    (with an expert axis: x [E, T, K], or broadcast over E).

    JAX's dispatch: the kernel (fp8_matmul) takes a K that is a multiple of
    128 packed in 128-blocks, at any N (JAX pads a ragged N to 128 for its
    kernel; this one masks it); every other weight runs fp8_matmul_ref, as
    in JAX. use_kernel=None (JAX's default) takes the kernel route for a
    CUDA x and, for a CPU x, fp8_matmul_ref with its exact decode, as JAX
    does off its accelerator; use_kernel=False runs fp8_matmul_ref always.
    exact: the kernel route's decode (fp8_matmul), False by default as in
    JAX."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if out_dtype is None:
        out_dtype = x.dtype if x.dtype != torch.float32 else torch.bfloat16
    w8, se = lin["w8"], lin["se"]
    k = x.shape[-1]
    n = w8.shape[-2]
    k_aligned = k % BLOCK == 0 and k // se.shape[-2] == BLOCK
    if w8.dim() == 3:
        x2 = x
    else:
        x2 = x.reshape(-1, k)
    if use_kernel and k_aligned:
        y = fp8_matmul(x2, w8, se, out_dtype, exact)
    else:
        y = fp8_matmul_ref(x2, w8, se, out_dtype)
    return y if w8.dim() == 3 else y.reshape(x.shape[:-1] + (n,))
