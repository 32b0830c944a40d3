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

`attn_prologue` launches the CUDA kernel (csrc/attn_prologue.cu) for
CUDA tensors, or raises, and runs `attn_prologue_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common
from flatquant_torch.kernels.kv_cache import quantize_pack_kv
from flatquant_torch.models.llama import rotate_half

_NAME = "attn_prologue"
_LIB = "attn_prologue"
HD = 128


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
    cos_b = cos.to(torch.bfloat16).contiguous()
    sin_b = sin.to(torch.bfloat16).contiguous()
    kt = _bf16_as(k_t, torch.float32).contiguous()
    kti = _bf16_as(k_t_inv, torch.float32).contiguous()
    clips = common.clip_vector([kc_clip, vc_clip], dev)
    q_rot = torch.empty((B, S, nh * HD), dtype=qkv.dtype, device=dev)
    k_rot = torch.empty((B, S, nkv * HD), dtype=qkv.dtype, device=dev)
    kp, kparam, vp, vparam = cache
    rc = common.lib(_LIB).fq_attn_prologue(
        qkv.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), kt.data_ptr(),
        kti.data_ptr(), clips.data_ptr(), q_rot.data_ptr(), k_rot.data_ptr(),
        kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(), vparam.data_ptr(),
        B, S, nh, nkv, L, int(pos), int(qkv.dtype == torch.float32),
        common.stream_ptr(qkv))
    common.check(_LIB, _NAME, rc)
    common.LAUNCHES[_NAME] += 1
    v = qkv[..., (nh + nkv) * HD:]
    return (q_rot, k_rot, v, kp, kparam, vp, vparam)
