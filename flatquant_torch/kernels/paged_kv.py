"""Block-table (paged) int4 KV cache: the pool, its writes, and attention
through the table (port of flatquant_tpu/kernels/paged_kv.py).

The port keeps one pool per layer, each block token-major like the slot
cache (kernels/kv_cache.py):
  codes  [n_blocks, nkv, bs, hd/2] uint8
  params [n_blocks, nkv, bs, 2]    f32 (scale, zero)
and a per-slot block table tbl [B, mb] int32 of pool indices, managed on
the host (serving/paged.py). Token t of slot b lies in block
tbl[b, t // bs] at offset t % bs. Block 0 is the trash block. JAX's
pool ([L, n_blocks, nkv, hd/2, bs], token index on the TPU's lanes)
converts through utils/convert.py.

The writes are XLA scatters in JAX; here they are plain indexing, IN
PLACE. Attention: `paged_decode_attention_int4` and
`paged_chunk_attention_int4` launch the slot kernels' bodies with the
tile address looked up through the table (csrc/kv_cache.cu), so they
sum in the slot kernels' order (the decode body's spans are absolute
positions); each runs its plain version (gather, then
the slot cache's plain math) for CPU tensors.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common
from flatquant_torch.kernels.kv_cache import (
    _chunk_rows,
    _chunk_unrows,
    check_attention_args,
    chunk_scores_ref,
    decode_attention_ref,
    decode_workspace,
)

_DECODE = "paged_decode_attention_int4"
_CHUNK = "paged_chunk_attention_int4"


def init_paged_pool(num_layers: int, n_blocks: int, nkv: int, hd: int,
                    block_size: int, device="cuda"):
    """The shared block pool, one zeroed tensor per layer for each of
    "kp"/"vp" [n_blocks, nkv, bs, hd/2] uint8 and "kparam"/"vparam"
    [n_blocks, nkv, bs, 2] float32. block_size % 128 == 0, as in JAX (a
    128-token tile of the attention kernels then never straddles a
    block)."""
    assert block_size % 128 == 0, "token tiles must not straddle blocks"
    dev = common.resolve_device(device)

    def zeros(last, dt):
        return [torch.zeros((n_blocks, nkv, block_size, last), dtype=dt,
                            device=dev) for _ in range(num_layers)]

    return {"kp": zeros(hd // 2, torch.uint8),
            "kparam": zeros(2, torch.float32),
            "vp": zeros(hd // 2, torch.uint8),
            "vparam": zeros(2, torch.float32)}


# ---------------------------------------------------------------------------
# pool writes, in place
# ---------------------------------------------------------------------------


def write_prompt_paged(pool_c, pool_p, codes, params, tbl):
    """Write a prompt's packed K or V into the pool, in place.

    pool_c [nb, nkv, bs, hd/2]; pool_p [nb, nkv, bs, 2]; codes
    [B, nkv, S, hd/2] and params [B, nkv, S, 2] (token-major, from
    pack_kv_token_major), positions [0, S); tbl [B, mb]. S may end
    mid-block."""
    bs = pool_c.shape[2]
    S = codes.shape[2]
    tbl = tbl.long()
    nb_full, tail = divmod(S, bs)
    for j in range(nb_full):
        pool_c[tbl[:, j]] = codes[:, :, j * bs:(j + 1) * bs]
        pool_p[tbl[:, j]] = params[:, :, j * bs:(j + 1) * bs]
    if tail:
        blk = tbl[:, nb_full]
        pool_c[blk, :, :tail] = codes[:, :, nb_full * bs:]
        pool_p[blk, :, :tail] = params[:, :, nb_full * bs:]
    return pool_c, pool_p


def write_chunk_paged(pool_c, pool_p, codes, params, tbl, start: int):
    """Write a prefill chunk's packed K or V at positions
    [start, start + S) through the table, in place; the chunk may
    straddle block edges. codes [B, nkv, S, hd/2], params
    [B, nkv, S, 2]; tbl [B, mb]."""
    B, nkv, S, hdh = codes.shape
    bs = pool_c.shape[2]
    pos = start + torch.arange(S, device=pool_c.device)
    blk = tbl.long()[:, pos // bs].reshape(-1)  # [B*S]
    off = (pos % bs).repeat(B)
    pool_c[blk, :, off] = codes.permute(0, 2, 1, 3).reshape(B * S, nkv, hdh)
    pool_p[blk, :, off] = params.permute(0, 2, 1, 3).reshape(B * S, nkv, 2)
    return pool_c, pool_p


def write_token_paged(pool_c, pool_p, codes1, params1, tbl, pos):
    """Write one decode token per slot, in place: slot b's token lands in
    block tbl[b, pos[b] // bs] at offset pos[b] % bs. codes1
    [B, nkv, hd/2], params1 [B, nkv, 2], pos [B]. A position past the
    table reads its last entry, as JAX's clamped gather does (the
    batcher's inactive slots; their tables point at the trash block)."""
    bs = pool_c.shape[2]
    B, mb = tbl.shape
    pos = pos.to(pool_c.device).long()
    col = torch.clamp(pos // bs, 0, mb - 1)
    blk = tbl.long()[torch.arange(B, device=pool_c.device), col]
    off = pos % bs
    pool_c[blk, :, off] = codes1
    pool_p[blk, :, off] = params1
    return pool_c, pool_p


def gather_kv_paged(pool_c, pool_p, tbl):
    """The slot-cache view of the pool: token-major codes
    [B, nkv, mb*bs, hd/2] and params [B, nkv, mb*bs, 2] (plain versions
    and tests)."""
    g_c = pool_c[tbl.long()]  # [B, mb, nkv, bs, hd/2]
    g_p = pool_p[tbl.long()]
    B, mb, nkv, bs, hdh = g_c.shape
    codes = g_c.permute(0, 2, 1, 3, 4).reshape(B, nkv, mb * bs, hdh)
    params = g_p.permute(0, 2, 1, 3, 4).reshape(B, nkv, mb * bs, 2)
    return codes, params


# ---------------------------------------------------------------------------
# attention through the table
# ---------------------------------------------------------------------------


def paged_decode_attention_ref(q, kp, kparam, vp, vparam, tbl, valid_len,
                               sm_scale: float):
    """Plain version: gather the pool through the table, then
    decode_attention_ref. Returns [B, nh, hd] in q.dtype."""
    kc, kpr = gather_kv_paged(kp, kparam, tbl)
    vc, vpr = gather_kv_paged(vp, vparam, tbl)
    return decode_attention_ref(q, kc, kpr[..., 0:1], kpr[..., 1:2], vc,
                                vpr[..., 0:1], vpr[..., 1:2], valid_len,
                                sm_scale)


def paged_chunk_attention_ref(q, kp, kparam, vp, vparam, tbl, pos,
                              sm_scale: float):
    """Plain version: gather the pool through the table, then the slot
    cache's chunk chain (kv_cache.chunk_scores_ref). Returns
    [B, Sq, nh, hd] in q.dtype."""
    kc, kpr = gather_kv_paged(kp, kparam, tbl)
    vc, vpr = gather_kv_paged(vp, vparam, tbl)
    return chunk_scores_ref(q, kc, kpr, vc, vpr, pos, sm_scale).to(q.dtype)


def _check_pool(name, q, kp, kparam, vp, vparam, tbl, per_slot):
    """Argument checks of the paged kernels; returns (nkv, mb, bs)."""
    nb, nkv, bs, hdh = kp.shape
    B, mb = tbl.shape
    check_attention_args(name, q, nkv, (kp, vp), (kparam, vparam))
    req = common.require
    req(tuple(vp.shape) == (nb, nkv, bs, hdh)
        and tuple(kparam.shape) == tuple(vparam.shape) == (nb, nkv, bs, 2),
        name, "pool shapes disagree")
    req(bs % 128 == 0, name, f"block size {bs} must be a multiple of 128")
    req(q.shape[0] == B and tbl.device == q.device, name,
        "tbl must be [B, max_blocks] on q's device")
    req(torch.is_tensor(per_slot) and per_slot.numel() == B
        and per_slot.device == q.device, name,
        "the per-slot lengths/positions must be a [B] tensor on q's device")
    return nkv, mb, bs


def paged_decode_attention_int4(q, kp, kparam, vp, vparam, tbl, valid_len,
                                sm_scale: float):
    """One-token GQA attention over the block pool.

    q [B, nh, hd] (rotated into the K space); kp/vp [nb, nkv, bs, hd/2]
    uint8, kparam/vparam [nb, nkv, bs, 2] f32; tbl [B, mb] int; valid_len
    [B] int: positions < valid_len attend, 0 gives 0. Returns [B, nh, hd]
    in q.dtype. CUDA tensors launch the kernel (hd 128, n_rep from 1 to
    8, bs % 128 == 0) or raise; CPU tensors run
    paged_decode_attention_ref."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, kp, kparam, vp, vparam, tbl,
                                          valid_len, sm_scale)
    return _launch_decode_paged(q, kp, kparam, vp, vparam, tbl, valid_len,
                                sm_scale)


def _launch_decode_paged(q, kp, kparam, vp, vparam, tbl, valid_len,
                         sm_scale):
    """Check paged_decode_attention_int4's arguments and launch its
    kernel."""
    B, nh, hd = q.shape
    nkv, mb, bs = _check_pool(_DECODE, q, kp, kparam, vp, vparam, tbl,
                              valid_len)
    qf = q.to(torch.float32).contiguous()
    tbl32 = tbl.to(torch.int32).contiguous()
    valid = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, nh, hd), dtype=torch.float32, device=q.device)
    ws, tickets, span = decode_workspace(B, nkv, nh // nkv, mb * bs,
                                         q.device)
    rc = common.lib("kv_cache").fq_paged_decode_attention_int4(
        qf.data_ptr(), kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(),
        vparam.data_ptr(), tbl32.data_ptr(), valid.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), B, nkv, nh // nkv, mb, bs, span,
        float(sm_scale), common.stream_ptr(q))
    common.check("kv_cache", _DECODE, rc)
    common.LAUNCHES[_DECODE] += 1
    return out.to(q.dtype)


def paged_chunk_attention_int4(q, kp, kparam, vp, vparam, tbl, pos,
                               sm_scale: float):
    """Chunked-prefill attention over the block pool (the paged twin of
    kv_cache.chunk_attention_int4).

    q [B, Sq, nh, hd]; pools as paged_decode_attention_int4, already
    holding the chunk's K/V; tbl [B, mb]; pos [B] int, the chunk's first
    position: row s attends ids <= pos + s. Returns [B, Sq, nh, hd] in
    q.dtype. CUDA tensors launch the kernel or raise; CPU tensors run
    paged_chunk_attention_ref."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, kp, kparam, vp, vparam, tbl, pos,
                                         sm_scale)
    return _launch_chunk_paged(q, kp, kparam, vp, vparam, tbl, pos, sm_scale)


def _launch_chunk_paged(q, kp, kparam, vp, vparam, tbl, pos, sm_scale):
    """Check paged_chunk_attention_int4's arguments and launch its
    kernel."""
    B, sq = q.shape[:2]
    nkv, mb, bs = _check_pool(_CHUNK, q, kp, kparam, vp, vparam, tbl, pos)
    qr = _chunk_rows(q, nkv)
    out = torch.empty_like(qr)
    tbl32 = tbl.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    rc = common.lib("kv_cache").fq_paged_chunk_attention_int4(
        qr.data_ptr(), kp.data_ptr(), kparam.data_ptr(), vp.data_ptr(),
        vparam.data_ptr(), tbl32.data_ptr(), pos32.data_ptr(),
        out.data_ptr(), B, nkv, qr.shape[2], sq, mb, bs, float(sm_scale),
        common.stream_ptr(q))
    common.check("kv_cache", _CHUNK, rc)
    common.LAUNCHES[_CHUNK] += 1
    return _chunk_unrows(out, q)
