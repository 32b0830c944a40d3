"""Fused attention prologue of the prefill (port of
flatquant_tpu/kernels/attn_prologue.py).

After the merged qkv GEMM, one pass splits q/k/v, applies RoPE, rotates q
by Pk^{-T} (k_t_inv) and k by Pk (k_t), and quantizes K and V to the
asymmetric int4 cache format. The outputs use the port's layouts:

  q_rot      [B, S, nh*128]      roped, rotated (token-major)
  k_rot      [B, S, nkv*128]     roped, rotated, token-major (the prefill
                                 attends with UNQUANTIZED K and V)
  v          [B, S, nkv*128]     a view of qkv (no copy)
  k/v codes  [B, nkv, L, 64] u8  planar nibbles, byte c = q[c] | q[c+64]<<4
  k/v params [B, nkv, L, 2] f32  (scale, zero)

The codes and params go straight into the layer's token-major cache at
positions [pos, pos + S) when `cache` is given (IN PLACE), or into fresh
tensors of length S. JAX's transposed K [B, nkv, 128, S] and v4 cache
layout are TPU lane choices; the tests compare through `untranspose_kv`.

Rounding points, as in the JAX kernel: cos, sin, k_t and k_t_inv are
used in bf16; RoPE runs in qkv's dtype with a rounding after each op;
the head products sum in float32 and round to qkv's dtype; K is quantized
from that rounded K, V from the raw V.

`attn_prologue` launches a CUDA kernel (csrc/attn_prologue.cu) for CUDA
tensors, or raises, and runs `attn_prologue_ref` for CPU tensors. The
kernel has two device bodies, and `prologue_body(dtype)` picks one:

  "mma"   bf16 qkv: the head products on the tensor cores (wgmma bf16,
          float32 sums), qkv by TMA, RoPE in registers
  "simt"  float32 qkv: the products on the CUDA cores in float32 (its
          rope outputs are not bf16 values, so they are no bf16 operands)

`common.BODY_LAUNCHES["attn_prologue"]` counts the launches of each.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common
from flatquant_torch.kernels.kv_cache import quantize_pack_kv
from flatquant_torch.models.llama import rotate_half

_NAME = "attn_prologue"
_LIB = "attn_prologue"
_BODY_FN = {"simt": "fq_attn_prologue", "mma": "fq_attn_prologue_mma"}
HD = 128


# the bf16 body's token tile (csrc/attn_prologue.cu PM_BT), and the
# fewest blocks its grid should hold: four an SM of 132 (two are
# resident), below which a block walks fewer heads
# (timed on an H100, PERF.md: at 1 x 2048, llama-2-7b's 32/32 heads
# ran fastest at 4 q heads or 2 k + 2 v heads a block, 768 blocks;
# Qwen-2.5-7B's 28/4 ~16% slower there, 288 blocks, than at 2 and 1 + 1)
PRO_TOKENS = 64
PRO_MIN_BLOCKS = 4 * 132


def prologue_heads(B: int, S: int, nh: int, nkv: int):
    """(q heads, k heads) a block of the bf16 body walks (a k block then
    walks as many v heads): 4 and 2, halved while the grid holds fewer
    than PRO_MIN_BLOCKS blocks."""
    tiles = B * -(-S // PRO_TOKENS)
    qh, kvh = 4, 2
    while qh > 1 and tiles * (-(-nh // qh) + -(-nkv // kvh)) < PRO_MIN_BLOCKS:
        qh, kvh = qh // 2, max(1, kvh // 2)
    return qh, kvh


def prologue_body(dtype) -> str:
    """The device body a qkv of `dtype` takes: "mma" (bf16) or "simt"
    (float32)."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def _bf16_as(t, dtype):
    return t.to(torch.bfloat16).to(dtype)


def _new_cache(B, nkv, S, device):
    return (torch.empty((B, nkv, S, HD // 2), dtype=torch.uint8,
                        device=device),
            torch.empty((B, nkv, S, 2), dtype=torch.float32, device=device),
            torch.empty((B, nkv, S, HD // 2), dtype=torch.uint8,
                        device=device),
            torch.empty((B, nkv, S, 2), dtype=torch.float32, device=device))


def attn_prologue_ref(qkv, cos, sin, k_t, k_t_inv, kc_clip=None,
                      vc_clip=None, nh: int = 32, nkv: int = 32, cache=None,
                      pos: int = 0):
    """Plain version: the composed chain at the kernel's rounding
    points. Returns (q_rot, k_rot, v, kp, kparam, vp, vparam)."""
    B, S, _ = qkv.shape
    dt = qkv.dtype
    q, k, v = torch.split(qkv, [nh * HD, nkv * HD, nkv * HD], dim=-1)
    c = _bf16_as(cos, dt)[None, :, None, :]
    s = _bf16_as(sin, dt)[None, :, None, :]

    def rope(x, h):
        x = x.reshape(B, S, h, HD)
        return x * c + rotate_half(x) * s

    def head_mat(x, mat):
        return (x.to(torch.float32) @ _bf16_as(mat, torch.float32)).to(dt)

    q_rot = head_mat(rope(q, nh), k_t_inv).reshape(B, S, nh * HD)
    k_rot = head_mat(rope(k, nkv), k_t)
    out = _new_cache(B, nkv, S, qkv.device) if cache is None else cache
    at = slice(pos, pos + S)
    for t, clip, codes, params in ((k_rot, kc_clip, out[0], out[1]),
                                   (v.reshape(B, S, nkv, HD), vc_clip,
                                    out[2], out[3])):
        pk, sc, zr = quantize_pack_kv(t, clip)
        codes[:, :, at] = pk.transpose(1, 2)
        params[:, :, at] = torch.cat([sc, zr], dim=-1).transpose(1, 2)
    return (q_rot, k_rot.reshape(B, S, nkv * HD), v, *out)


def attn_prologue(qkv, cos, sin, k_t, k_t_inv, kc_clip=None, vc_clip=None,
                  nh: int = 32, nkv: int = 32, cache=None, pos: int = 0):
    """qkv [B, S, (nh + 2*nkv)*128] (bf16 or f32; head_dim 128); cos/sin
    [S, 128] rope tables of positions [pos, pos + S); k_t, k_t_inv
    [128, 128]; clips (cmax, cmin) or None; cache: the layer's
    (kp, kparam, vp, vparam) token-major cache tensors [B, nkv, L, .],
    written IN PLACE at [pos, pos + S), or None for fresh tensors of
    length S. Returns (q_rot, k_rot, v, kp, kparam, vp, vparam). CUDA
    tensors launch the kernel or raise; CPU tensors run the plain
    version."""
    if qkv.device.type == "cpu":
        return attn_prologue_ref(qkv, cos, sin, k_t, k_t_inv, kc_clip,
                                 vc_clip, nh, nkv, cache, pos)
    B, S, D = qkv.shape
    dev = qkv.device
    req = common.require
    req(all(t.device == dev for t in (cos, sin, k_t, k_t_inv)), _NAME,
        "all inputs must be on the same CUDA device")
    req(qkv.dtype in (torch.bfloat16, torch.float32), _NAME,
        f"qkv dtype {qkv.dtype} must be bfloat16 or float32")
    req(D == (nh + 2 * nkv) * HD and tuple(cos.shape) == (S, HD)
        and tuple(sin.shape) == (S, HD)
        and tuple(k_t.shape) == tuple(k_t_inv.shape) == (HD, HD), _NAME,
        f"shapes qkv {tuple(qkv.shape)} (nh {nh}, nkv {nkv}, head_dim "
        f"128), cos {tuple(cos.shape)}, k_t {tuple(k_t.shape)}")
    if cache is None:
        cache, L, pos = _new_cache(B, nkv, S, dev), S, 0
    else:
        L = cache[0].shape[2]
        req(all(t.device == dev and t.is_contiguous() for t in cache)
            and tuple(cache[0].shape) == tuple(cache[2].shape)
            == (B, nkv, L, HD // 2)
            and tuple(cache[1].shape) == tuple(cache[3].shape) == (B, nkv, L, 2)
            and cache[0].dtype == cache[2].dtype == torch.uint8
            and cache[1].dtype == cache[3].dtype == torch.float32, _NAME,
            "cache tensors must be contiguous [B, nkv, L, 64] uint8 and "
            "[B, nkv, L, 2] float32")
        req(0 <= pos and pos + S <= L, _NAME,
            f"positions [{pos}, {pos + S}) outside the cache length {L}")
    qkv = qkv.contiguous()
    q_rot, k_rot = launch_prologue(
        qkv, cos.to(torch.bfloat16).contiguous(),
        sin.to(torch.bfloat16).contiguous(), k_t, k_t_inv,
        common.clip_vector([kc_clip, vc_clip], dev), cache, nh, nkv, pos)
    v = qkv[..., (nh + nkv) * HD:]
    return (q_rot, k_rot, v, *cache)


def launch_prologue(qkv, cos_b, sin_b, k_t, k_t_inv, clips, cache, nh, nkv,
                    pos):
    """Launch the body prologue_body picks on checked tensors (qkv
    contiguous, cos_b / sin_b bf16 [S, 128], clips the kernel's float32
    vector, cache the four token-major tensors); raise if the launch fails
    (no other body is tried). Counted under LAUNCHES and, by body,
    BODY_LAUNCHES. Returns (q_rot, k_rot)."""
    B, S, _ = qkv.shape
    L = cache[0].shape[2]
    q_rot = torch.empty((B, S, nh * HD), dtype=qkv.dtype, device=qkv.device)
    k_rot = torch.empty((B, S, nkv * HD), dtype=qkv.dtype, device=qkv.device)
    body = prologue_body(qkv.dtype)
    if body == "mma":  # the products' B operands: k_t^T, k_t_inv^T in bf16
        common.require(qkv.data_ptr() % 16 == 0, _NAME,
                       "qkv must start 16-byte aligned (it comes by TMA)")
        mats = [m.to(torch.bfloat16).t().contiguous() for m in (k_t, k_t_inv)]
        extra = prologue_heads(B, S, nh, nkv)
    else:
        mats = [_bf16_as(m, torch.float32).contiguous() for m in (k_t, k_t_inv)]
        extra = (int(qkv.dtype == torch.float32),)
    fn = getattr(common.lib(_LIB), _BODY_FN[body])
    rc = fn(qkv.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            *(m.data_ptr() for m in mats), clips.data_ptr(),
            q_rot.data_ptr(), k_rot.data_ptr(), *(t.data_ptr() for t in cache),
            B, S, nh, nkv, L, int(pos), *extra, common.stream_ptr(qkv))
    common.check(_LIB, _NAME, rc)
    common.LAUNCHES[_NAME] += 1
    common.BODY_LAUNCHES[_NAME][body] += 1
    return q_rot, k_rot
