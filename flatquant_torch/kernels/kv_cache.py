"""Packed asymmetric-int4 KV cache: quantize/pack, decode attention and
the per-slot token write (port of flatquant_tpu/kernels/kv_cache.py).

The port stores its cache token-major, per layer:
  codes  [B, nkv, S, hd/2] uint8  (byte c = q[c] | q[c + hd/2] << 4)
  params [B, nkv, S, 2]    f32    (scale, zero) per (token, head)
which is the layout of the JAX package's `decode_attention_ref` and
`untranspose_kv`. JAX's v4 layout ([B, nkv, hd/2, S], token index on the
TPU's lanes) is a VMEM choice; `pack_kv_transposed` / `untranspose_kv`
convert to and from it for the tests.

Kernels (csrc/kv_cache.cu): `decode_attention_int4` and `write_token`.
Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common

_ATTN = "decode_attention_int4"
_WRITE = "write_token"


# ---------------------------------------------------------------------------
# quantize / pack
# ---------------------------------------------------------------------------


def quantize_pack_kv(t: torch.Tensor, clip=None):
    """t [..., hd] -> (packed uint8 [..., hd/2], scale [..., 1],
    zero [..., 1]), asym int4 per (token, head):
    q = clip(round(x / scale) + zero, 0, 15)."""
    hd = t.shape[-1]
    tf = t.to(torch.float32)
    tmax = torch.clamp(tf.amax(dim=-1, keepdim=True), min=0.0)
    tmin = torch.clamp(tf.amin(dim=-1, keepdim=True), max=0.0)
    if clip is not None:
        cmax, cmin = clip
        tmax = tmax * cmax
        tmin = tmin * cmin
    degenerate = (tmin == 0) & (tmax == 0)
    tmin = torch.where(degenerate, -1.0, tmin)
    tmax = torch.where(degenerate, 1.0, tmax)
    scale = (tmax - tmin) / 15.0
    zero = torch.round(-tmin / scale)
    q = torch.clamp(torch.round(tf / scale) + zero, 0, 15).to(torch.uint8)
    return q[..., : hd // 2] | (q[..., hd // 2:] << 4), scale, zero


def unpack_dequant_kv(packed, scale, zero, dtype=torch.bfloat16):
    """Inverse of quantize_pack_kv (plain path)."""
    lo = (packed & 0xF).to(torch.float32)
    hi = ((packed >> 4) & 0xF).to(torch.float32)
    q = torch.cat([lo, hi], dim=-1)
    return ((q - zero) * scale).to(dtype)


def pack_kv_token_major(t: torch.Tensor, clip=None):
    """t [B, S, nkv, hd] -> (codes [B, nkv, S, hd/2] uint8,
    params [B, nkv, S, 2] f32), the port's cache layout."""
    pk, sc, zr = quantize_pack_kv(t, clip)
    codes = pk.permute(0, 2, 1, 3).contiguous()
    params = torch.cat([sc, zr], dim=-1).permute(0, 2, 1, 3).contiguous()
    return codes, params


def pack_kv_transposed(t: torch.Tensor, clip=None):
    """quantize_pack_kv into JAX's v4 layout: t [B, S, nkv, hd] ->
    (codes [B, nkv, hd/2, S], params [B, nkv, 2, S])."""
    pk, sc, zr = quantize_pack_kv(t, clip)
    codes = pk.permute(0, 2, 3, 1).contiguous()
    params = torch.cat([sc, zr], dim=-1).permute(0, 2, 3, 1).contiguous()
    return codes, params


def untranspose_kv(codes, params):
    """JAX v4 layout -> token-major (packed [B, nkv, S, hd/2],
    scale [B, nkv, S, 1], zero [B, nkv, S, 1])."""
    pk = codes.transpose(2, 3).contiguous()
    par = params.transpose(2, 3)
    return pk, par[..., 0:1].contiguous(), par[..., 1:2].contiguous()


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def decode_attention_ref(q, kp, ks, kz, vp, vs, vz, valid_len, sm_scale):
    """Plain version. q [B, nh, hd]; kp/vp [B, nkv, S, hd/2];
    ks.. [B, nkv, S, 1]; valid_len [B]. Positions < valid_len attend; a
    row with valid_len 0 gives 0. Returns [B, nh, hd] in q.dtype."""
    B, nkv, S, _ = kp.shape
    n_rep = q.shape[1] // nkv
    k = unpack_dequant_kv(kp, ks, kz, torch.float32)
    v = unpack_dequant_kv(vp, vs, vz, torch.float32)
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.to(torch.float32), k) * sm_scale
    lim = valid_len.reshape(-1, 1, 1).to(scores.device)
    ids = torch.arange(S, device=scores.device).reshape(1, 1, S)
    scores = torch.where(ids < lim, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs, v)
    out = torch.where(lim > 0, out, 0.0)
    return out.to(q.dtype)


def decode_attention_int4(q, kp, kparam, vp, vparam, valid_len,
                          sm_scale: float):
    """One-token GQA attention over the token-major int4 cache.

    q [B, nh, hd] (already rotated into the K space); kp/vp
    [B, nkv, S, hd/2] uint8; kparam/vparam [B, nkv, S, 2] f32;
    valid_len [B] int. Returns [B, nh, hd] in q.dtype. CUDA tensors
    launch the kernel (hd 128, n_rep in {1, 2, 4, 8}) or raise; CPU
    tensors run decode_attention_ref."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, kp, kparam[..., 0:1], kparam[..., 1:2],
                                    vp, vparam[..., 0:1], vparam[..., 1:2],
                                    valid_len, sm_scale)
    B, nh, hd = q.shape
    _, nkv, S, hdh = kp.shape
    req = common.require
    req(all(t.device == q.device for t in (kp, kparam, vp, vparam, valid_len)),
        _ATTN, "all inputs must be on the same CUDA device")
    req(hd == 128 and hdh == 64, _ATTN, f"head_dim must be 128, got {hd}")
    req(nh % nkv == 0 and nh // nkv in (1, 2, 4, 8), _ATTN,
        f"n_rep = {nh}/{nkv} must be 1, 2, 4 or 8")
    req(kp.dtype == torch.uint8 and vp.dtype == torch.uint8
        and kparam.dtype == torch.float32 and vparam.dtype == torch.float32,
        _ATTN, "codes must be uint8 and params float32")
    req(tuple(kp.shape) == tuple(vp.shape) == (B, nkv, S, hdh)
        and tuple(kparam.shape) == tuple(vparam.shape) == (B, nkv, S, 2)
        and valid_len.numel() == B, _ATTN, "cache shapes disagree")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (kp, kparam, vp, vparam)), _ATTN,
        "cache tensors must be contiguous and 16-byte aligned")
    qf = q.to(torch.float32).contiguous()
    valid = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, nh, hd), dtype=torch.float32, device=q.device)
    rc = common.lib("kv_cache").fq_decode_attention_int4(
        qf.data_ptr(), kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(),
        vparam.data_ptr(), valid.data_ptr(), out.data_ptr(), B, nkv,
        nh // nkv, S, float(sm_scale), common.stream_ptr(q))
    common.check("kv_cache", _ATTN, rc)
    common.LAUNCHES[_ATTN] += 1
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# per-slot single-token write (continuous-batching decode), in place
# ---------------------------------------------------------------------------


def write_token_ref(kp, kparam, vp, vparam, kq, kpar, vq, vpar, pos):
    """Plain version: the masked select of flatquant_tpu/serving/
    engine.py:497-504 on the token-major layout, copied back IN PLACE.
    Slot b's token lands at pos[b]; a position outside [0, S) writes
    nothing."""
    S = kp.shape[2]
    ids = torch.arange(S, device=kp.device).reshape(1, 1, S, 1)
    hit = ids == pos.to(kp.device).reshape(-1, 1, 1, 1)
    kp.copy_(torch.where(hit, kq, kp))
    vp.copy_(torch.where(hit, vq, vp))
    kparam.copy_(torch.where(hit, kpar, kparam))
    vparam.copy_(torch.where(hit, vpar, vparam))
    return kp, kparam, vp, vparam


def write_token(kp, kparam, vp, vparam, kq, kpar, vq, vpar, pos):
    """Write each slot's one new token into the token-major cache, IN
    PLACE. kp/vp [B, nkv, S, hd/2] u8 and kparam/vparam [B, nkv, S, 2] f32
    are updated and returned; kq/vq [B, nkv, 1, hd/2] u8, kpar/vpar
    [B, nkv, 1, 2] f32; pos [B] int. CUDA tensors launch the kernel (or
    raise); CPU tensors run write_token_ref."""
    if kp.device.type == "cpu":
        return write_token_ref(kp, kparam, vp, vparam, kq, kpar, vq, vpar,
                               pos)
    B, nkv, S, hdh = kp.shape
    req = common.require
    req(all(t.device == kp.device
            for t in (kparam, vp, vparam, kq, kpar, vq, vpar, pos)),
        _WRITE, "all inputs must be on the same CUDA device")
    req(kp.dtype == vp.dtype == kq.dtype == vq.dtype == torch.uint8
        and kparam.dtype == vparam.dtype == kpar.dtype == vpar.dtype
        == torch.float32, _WRITE, "codes must be uint8 and params float32")
    req(tuple(vp.shape) == (B, nkv, S, hdh)
        and tuple(kparam.shape) == tuple(vparam.shape) == (B, nkv, S, 2)
        and tuple(kq.shape) == tuple(vq.shape) == (B, nkv, 1, hdh)
        and tuple(kpar.shape) == tuple(vpar.shape) == (B, nkv, 1, 2)
        and pos.numel() == B, _WRITE, "shapes disagree")
    req(all(t.is_contiguous() for t in (kp, kparam, vp, vparam)), _WRITE,
        "the cache must be contiguous (it is written in place)")
    kq, kpar, vq, vpar = (t.contiguous() for t in (kq, kpar, vq, vpar))
    pos32 = pos.to(torch.int32).contiguous()
    rc = common.lib("kv_cache").fq_write_token(
        kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(), vparam.data_ptr(),
        kq.data_ptr(), kpar.data_ptr(), vq.data_ptr(), vpar.data_ptr(),
        pos32.data_ptr(), B, nkv, S, hdh, common.stream_ptr(kp))
    common.check("kv_cache", _WRITE, rc)
    common.LAUNCHES[_WRITE] += 1
    return kp, kparam, vp, vparam
