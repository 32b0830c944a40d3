"""Packed asymmetric-int4 KV cache: quantize/pack, decode attention and
the per-slot token write (port of flatquant_tpu/kernels/kv_cache.py).

The port stores its cache token-major, per layer:
  codes  [B, nkv, S, hd/2] uint8  (byte c = q[c] | q[c + hd/2] << 4)
  params [B, nkv, S, 2]    f32    (scale, zero) per (token, head)
which is the layout of the JAX package's `decode_attention_ref` and
`untranspose_kv`. JAX's v4 layout ([B, nkv, hd/2, S], token index on the
TPU's lanes) is a VMEM choice; `pack_kv_transposed` / `untranspose_kv`
convert to and from it for the tests.

Kernels (csrc/kv_cache.cu): `decode_attention_int4`,
`chunk_attention_int4` and `write_token` (the block-pool twins of the
attention kernels are in kernels/paged_kv.py), and three more entry points
to the decode body, the JAX package's measured decode baselines:
`decode_attention_int4_v1` (JAX's `decode_attention_int4`, which
dequantizes every element) and `decode_attention_int4_wide` through the
body's DEQUANT instance, `decode_attention_int4_v3` (scale and zero folded)
through the body as `decode_attention_int4` runs it. Each wrapper launches
its kernel for CUDA tensors (or raises) and runs its plain version for CPU
tensors; the three baselines share decode_attention_ref.

The decode body splits each slot's sequence into spans of DECODE_SPAN
positions, one CTA each, and merges the spans' partials in the launch
(`decode_workspace`: a float32 workspace per call and an int32 ticket per
(slot, kv head), kept per device). The chunk body runs both products on
the tensor cores (csrc/kv_cache.cu).
"""

from __future__ import annotations

import torch

from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels import common

_ATTN = "decode_attention_int4"
_V1 = "decode_attention_int4_v1"
_WIDE = "decode_attention_int4_wide"
_V3 = "decode_attention_int4_v3"
_CHUNK = "chunk_attention_int4"
_WRITE = "write_token"

# positions a CTA of the decode body walks (a multiple of its 128-token
# tile): the split depends on absolute positions only, so the slot and
# paged instances sum in one order. 128 was the fastest of 128, 256 and
# 512 on the card (tools/attn_int4_sweep.py, PERF.md)
DECODE_SPAN = 128
# floats of one span's partial per query head: acc [128], then m, l, z
_PART = 128 + 3

# per device: the decode body's ticket arrays, int32, 0 between launches
# (the last is the one in use)
_TICKETS: dict = {}


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
    scale = true_div(tmax - tmin, 15.0)
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


def check_attention_args(name, q, nkv, codes, params):
    """The attention kernels' common argument checks: q (bf16 or f32) and
    the cache on one CUDA device, head_dim 128, n_rep from 1 to 8,
    uint8 codes and float32 params, contiguous and 16-byte aligned."""
    nh, hd = q.shape[-2], q.shape[-1]
    req = common.require
    req(all(t.device == q.device for t in (*codes, *params)), name,
        "all inputs must be on the same CUDA device")
    req(q.dtype in (torch.bfloat16, torch.float32), name,
        f"q dtype {q.dtype} must be bfloat16 or float32")
    req(hd == 128 and all(c.shape[-1] == 64 for c in codes), name,
        f"head_dim must be 128, got {hd}")
    req(nh % nkv == 0 and 1 <= nh // nkv <= 8, name,
        f"n_rep = {nh}/{nkv} must be a whole number from 1 to 8")
    req(all(c.dtype == torch.uint8 for c in codes)
        and all(p.dtype == torch.float32 for p in params), name,
        "codes must be uint8 and params float32")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (*codes, *params)), name,
        "cache tensors must be contiguous and 16-byte aligned")


def decode_tickets(n: int, device) -> torch.Tensor:
    """The per-device int32 tickets of the decode body, at least n of them.
    They start at 0 and each launch leaves them at 0 (the span that merges
    a (slot, kv head) resets its ticket), so they are allocated, zeroed,
    only when more are needed, never inside a CUDA graph capture (warm the
    call up first). Launches that share them run in stream order."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    arrays = _TICKETS.setdefault(dev, [])
    if not arrays or arrays[-1].numel() < n:
        common.require(
            not (dev.type == "cuda"
                 and torch.cuda.is_current_stream_capturing()),
            "decode_attention_int4",
            f"{n} decode tickets needed during a CUDA graph capture: run the "
            "call once before capturing it")
        # the smaller arrays stay alive: a captured graph may hold them
        arrays.append(torch.zeros(
            max(n, 2 * arrays[-1].numel() if arrays else 0),
            dtype=torch.int32, device=dev))
    return arrays[-1]


def decode_workspace(B, nkv, n_rep, s_eff, device):
    """(workspace, tickets, span) of one decode launch over s_eff positions
    a slot: the spans' partials, float32 [B * nkv * n_span * n_rep * 131]
    (no initial value: a span writes its partial before the last one
    reads it), decode_tickets(B * nkv) and DECODE_SPAN."""
    n_span = -(-s_eff // DECODE_SPAN)
    ws = torch.empty(B * nkv * n_span * n_rep * _PART, dtype=torch.float32,
                     device=device)
    return ws, decode_tickets(B * nkv, device), DECODE_SPAN


def _decode_ref(q, kp, kparam, vp, vparam, valid_len, sm_scale):
    return decode_attention_ref(q, kp, kparam[..., 0:1], kparam[..., 1:2],
                                vp, vparam[..., 0:1], vparam[..., 1:2],
                                valid_len, sm_scale)


def _launch_decode(name, symbol, q, kp, kparam, vp, vparam, valid_len,
                   sm_scale):
    """Check the arguments of a decode entry point and launch `symbol` of
    csrc/kv_cache.cu, counting the launch under `name`."""
    B, nh, hd = q.shape
    _, nkv, S, hdh = kp.shape
    check_attention_args(name, q, nkv, (kp, vp), (kparam, vparam))
    common.require(
        tuple(kp.shape) == tuple(vp.shape) == (B, nkv, S, hdh)
        and tuple(kparam.shape) == tuple(vparam.shape) == (B, nkv, S, 2)
        and valid_len.numel() == B and valid_len.device == q.device, name,
        "cache shapes disagree")
    qf = q.to(torch.float32).contiguous()
    valid = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, nh, hd), dtype=torch.float32, device=q.device)
    ws, tickets, span = decode_workspace(B, nkv, nh // nkv, S, q.device)
    rc = getattr(common.lib("kv_cache"), symbol)(
        qf.data_ptr(), kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(),
        vparam.data_ptr(), valid.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), B, nkv, nh // nkv, S, span,
        float(sm_scale), common.stream_ptr(q))
    common.check("kv_cache", name, rc)
    common.LAUNCHES[name] += 1
    return out.to(q.dtype)


def decode_attention_int4(q, kp, kparam, vp, vparam, valid_len,
                          sm_scale: float):
    """One-token GQA attention over the token-major int4 cache.

    q [B, nh, hd] (already rotated into the K space); kp/vp
    [B, nkv, S, hd/2] uint8; kparam/vparam [B, nkv, S, 2] f32;
    valid_len [B] int. Returns [B, nh, hd] in q.dtype. CUDA tensors
    launch the kernel (hd 128, n_rep from 1 to 8) or raise; CPU tensors
    run decode_attention_ref."""
    if q.device.type == "cpu":
        return _decode_ref(q, kp, kparam, vp, vparam, valid_len, sm_scale)
    return _launch_decode(_ATTN, "fq_decode_attention_int4", q, kp, kparam,
                          vp, vparam, valid_len, sm_scale)


def decode_attention_int4_v1(q, kp, kparam, vp, vparam, valid_len,
                             sm_scale: float):
    """JAX's `decode_attention_int4` (flatquant_tpu/kernels/kv_cache.py:190,
    a measured baseline there; the port's decode_attention_int4 is JAX's
    v4): decode_attention_int4's arguments and function, every K/V element
    dequantized, (code - zero) * scale, before the q.k and p.v products.
    CUDA tensors launch the decode kernel's DEQUANT instance (or raise);
    CPU tensors run decode_attention_ref."""
    if q.device.type == "cpu":
        return _decode_ref(q, kp, kparam, vp, vparam, valid_len, sm_scale)
    return _launch_decode(_V1, "fq_decode_attention_int4_dequant", q, kp,
                          kparam, vp, vparam, valid_len, sm_scale)


def decode_attention_int4_wide(q, kp, kparam, vp, vparam, valid_len,
                               sm_scale: float):
    """JAX's `decode_attention_int4_wide` (kv_cache.py:291): v1's function
    with one TPU grid step per batch element and key blocks of 512, which
    move only where the online max is taken. CUDA tensors launch the same
    DEQUANT instance as decode_attention_int4_v1 (or raise); CPU tensors
    run decode_attention_ref."""
    if q.device.type == "cpu":
        return _decode_ref(q, kp, kparam, vp, vparam, valid_len, sm_scale)
    return _launch_decode(_WIDE, "fq_decode_attention_int4_dequant", q, kp,
                          kparam, vp, vparam, valid_len, sm_scale)


def decode_attention_int4_v3(q, kp, kparam, vp, vparam, valid_len,
                             sm_scale: float):
    """JAX's `decode_attention_int4_v3` (kv_cache.py:386): scale and zero
    folded into the score and output epilogues on the token-major layout,
    which is decode_attention_int4's function and body. CUDA tensors launch
    that body (or raise), counted under this name; CPU tensors run
    decode_attention_ref."""
    if q.device.type == "cpu":
        return _decode_ref(q, kp, kparam, vp, vparam, valid_len, sm_scale)
    return _launch_decode(_V3, "fq_decode_attention_int4", q, kp, kparam, vp,
                          vparam, valid_len, sm_scale)


# ---------------------------------------------------------------------------
# chunk attention (chunked prefill over the cache)
# ---------------------------------------------------------------------------


def chunk_scores_ref(q, k_codes, k_par, v_codes, v_par, pos, sm_scale):
    """The masked-softmax chain of flatquant_tpu/serving/engine.py:538-560
    on token-major codes [B, nkv, S, hd/2] and params [B, nkv, S, 2]:
    q [B, Sq, nh, hd] rows s attend ids <= pos + s (pos an int or a [B]
    tensor), float32 dequantized K/V, a -1e9 bias. Returns float32
    [B, Sq, nh, hd]. Shared with the paged plain version."""
    sq, nh = q.shape[1], q.shape[2]
    k = unpack_dequant_kv(k_codes, k_par[..., 0:1], k_par[..., 1:2],
                          torch.float32)
    v = unpack_dequant_kv(v_codes, v_par[..., 0:1], v_par[..., 1:2],
                          torch.float32)
    n_rep = nh // k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    ids = torch.arange(k.shape[2], device=q.device).reshape(1, 1, 1, -1)
    iq = torch.arange(sq, device=q.device).reshape(1, 1, -1, 1)
    if torch.is_tensor(pos):
        pos = pos.to(q.device).reshape(-1, 1, 1, 1)
    bias = torch.where(ids <= pos + iq, 0.0, -1e9)
    scores = torch.einsum("bqhd,bhkd->bhqk", q.to(torch.float32), k)
    probs = torch.softmax(scores * sm_scale + bias, dim=-1)
    return torch.einsum("bhqk,bhkd->bqhd", probs, v)


def chunk_attention_ref(q, kp, kparam, vp, vparam, pos, sm_scale):
    """Plain version of chunk_attention_int4: q [B, Sq, nh, hd]; the
    token-major cache kp/vp [B, nkv, S, hd/2], kparam/vparam
    [B, nkv, S, 2]; pos [B] (or an int), the chunk's first position.
    Row s sees ids <= pos + s; there is no valid_len. Returns
    [B, Sq, nh, hd] in q.dtype."""
    return chunk_scores_ref(q, kp, kparam, vp, vparam, pos,
                            sm_scale).to(q.dtype)


def _chunk_rows(q, nkv):
    """q [B, Sq, nh, hd] -> float32 [B, nkv, n_rep * Sq, hd], row
    r = rep * Sq + s (the kernels' row order, JAX's too)."""
    B, sq, nh, hd = q.shape
    n_rep = nh // nkv
    return (q.to(torch.float32).reshape(B, sq, nkv, n_rep, hd)
            .permute(0, 2, 3, 1, 4).reshape(B, nkv, n_rep * sq, hd)
            .contiguous())


def _chunk_unrows(out, q):
    B, sq, nh, hd = q.shape
    nkv = out.shape[1]
    return (out.reshape(B, nkv, nh // nkv, sq, hd).permute(0, 3, 1, 2, 4)
            .reshape(B, sq, nh, hd).to(q.dtype))


def chunk_attention_int4(q, kp, kparam, vp, vparam, pos, sm_scale: float):
    """Chunked-prefill attention over the token-major int4 cache.

    q [B, Sq, nh, hd] (the chunk's queries, rotated into the K space);
    kp/vp [B, nkv, S, hd/2] uint8 and kparam/vparam [B, nkv, S, 2] f32,
    already holding the chunk's own K/V; pos [B] int, the chunk's first
    position: row s attends ids <= pos + s. Returns [B, Sq, nh, hd] in
    q.dtype. CUDA tensors launch the kernel (hd 128, n_rep from 1 to 8)
    or raise; CPU tensors run chunk_attention_ref."""
    if q.device.type == "cpu":
        return chunk_attention_ref(q, kp, kparam, vp, vparam, pos, sm_scale)
    return _launch_chunk(q, kp, kparam, vp, vparam, pos, sm_scale)


def _launch_chunk(q, kp, kparam, vp, vparam, pos, sm_scale):
    """Check chunk_attention_int4's arguments and launch its kernel."""
    B, sq, nh, _ = q.shape
    _, nkv, S, _ = kp.shape
    check_attention_args(_CHUNK, q, nkv, (kp, vp), (kparam, vparam))
    common.require(
        tuple(kp.shape) == tuple(vp.shape) == (B, nkv, S, 64)
        and tuple(kparam.shape) == tuple(vparam.shape) == (B, nkv, S, 2)
        and torch.is_tensor(pos) and pos.numel() == B
        and pos.device == q.device, _CHUNK, "cache or pos shapes disagree")
    qr = _chunk_rows(q, nkv)
    out = torch.empty_like(qr)
    pos32 = pos.to(torch.int32).contiguous()
    rc = common.lib("kv_cache").fq_chunk_attention_int4(
        qr.data_ptr(), kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(),
        vparam.data_ptr(), pos32.data_ptr(), out.data_ptr(), B, nkv,
        qr.shape[2], sq, S, float(sm_scale), common.stream_ptr(q))
    common.check("kv_cache", _CHUNK, rc)
    common.LAUNCHES[_CHUNK] += 1
    return _chunk_unrows(out, q)


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
