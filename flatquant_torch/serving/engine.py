"""Serving engine over the packed int4 slot cache and the bf16 cache
(port of flatquant_tpu/serving/engine.py).

Semantics follow the reference deploy stack:
  - prefill attends with *unquantized* (transformed) K/V while writing the
    quantized entries into the cache
  - decode attends over the quantized cache, q rotated by Pk^{-T} into the
    transformed K space
  - KV entries are asym-int4 per (token, head), k-transform applied
    before quantization

Three cache modes, as in JAX: "bf16" (the default) holds dequantized
values (quantize -> dequantize at write for k/v bits < 16;
`serving_layer`), "int4" packed nibbles read by the decode kernel
(`serving_layer_int4cache`), "paged" the same packed entries in a block
pool read through a block table (kernels/paged_kv.py; the cache dict
carries the table as "tbl").

Phases: "prefill" (the prompt from position 0), "decode" (one token per
slot, at a scalar or per-slot position) and "chunk" (S prompt tokens from
position pos, chunked prefill: row s attends the cache at ids <= pos + s,
decode semantics over the quantized history; chunk_attention_int4 /
paged_chunk_attention_int4 with use_kernel, their plain chain without).

Routes, as in JAX: with use_kernel and quantized activations, a prompt
of B*S >= 256 rows takes the fused flat-pipeline routes
(serving/quantized.py `_grouped_attn_in`, `_quant_mlp_grouped[_full]`)
wherever their qualifying conditions hold (the rn128 split's 128-wide
right factors); the balanced split's MLP takes the fused swiglu GEMM and,
at K >= 8192, the one-pass quant kernel (`_quant_swiglu`, `_quant_linear`).
Weight-only configs (a_bits 16) send every linear through the
weight-only branch of `_quant_linear` and take no fused route.
Over the int4 cache a prefill with S % 128 == 0 and 256 <= S takes the
fused attention prologue (`_fused_prefill_attention`: attn_prologue, flash
kt attention at S >= 1024 or dense attention below, left_quant_i8_flat for
the o head mixing, the o GEMM). Every other prefill attends through
kernels/prefill_attention.py `prefill_attention` (dense below 1024 tokens,
flash above: the kernel with use_kernel, JAX's blockwise oracle without).

What differs from JAX: the cache is a dict of per-layer lists of tensors
(the int4 codes in the token-major layout of kernels/kv_cache.py, the
pool's blocks token-major too), UPDATED IN PLACE by every phase (JAX
returns new, donated buffers); the layer loop is a Python loop over the
per-layer parameter list. Both of JAX's packed layouts serve: the
merged projections (qkv, upgate) and the unmerged ones (q, k, v, up,
gate), each with the standard or the perm transforms (ln_tp, ug_tp,
down_tp through kron_transform_perm, o_tp as a minor-dim head mix); the
fused routes qualify under JAX's conditions, which key on ln_t, down_t
and the merged qkv, so a perm or unmerged model takes the composed
routes, as in JAX.

Tensor parallelism (`tp_axis`, a parallel/mesh.py Axis; cfg is then the
rank's local config, parallel/serving_tp.py): the row-parallel o and down
all-reduce their partial sums over the axis and quantize with the global
per-token extrema (`_quant_linear(axis_name=...)`), and every fused route
declines, as in JAX, because its in-kernel scales are shard-local: a rank
runs the composed glue with w4a4_matmul_i8, the int4 decode attention,
write_token, and flash at S >= 1024. `attn_fn` replaces the prefill
attention of `serving_layer` (sequence parallelism passes ring attention,
parallel/sequence.py).

Tracing (utils/tracing.py, off by default): `_forward` records `embed`,
`rope_tables`, a `layer` span per layer (attribute `i`) and `head`; each
layer of either cache mode records `qkv`, `kv_write` (split, RoPE, pack
and cache write), `attn`, `o_proj` and `mlp`, and on the fused prefill
route `attn_fused` in place of `kv_write`, `attn` and `o_proj`.
"""

from __future__ import annotations

import numpy as np
import torch

from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels.attn_prologue import attn_prologue
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.flat_pipeline import left_quant_i8_flat
from flatquant_torch.kernels.int4_matmul import w4a4_matmul_i8
from flatquant_torch.kernels.kv_cache import (
    chunk_attention_int4,
    chunk_scores_ref,
    decode_attention_int4,
    decode_attention_ref,
    pack_kv_token_major,
    write_token,
    write_token_ref,
)
from flatquant_torch.kernels.paged_kv import (
    init_paged_pool,
    paged_chunk_attention_int4,
    paged_chunk_attention_ref,
    paged_decode_attention_int4,
    paged_decode_attention_ref,
    write_chunk_paged,
    write_prompt_paged,
    write_token_paged,
)
from flatquant_torch.kernels.prefill_attention import (
    dense_causal_attention,
    flash_prefill_attention_kt,
    is_flash,
    prefill_attention,
)
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import (
    apply_rope,
    rms_norm,
    rope_tables,
    rotate_half,
    silu,
)
from flatquant_torch.parallel.distributed import all_reduce
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.serving.quantized import (
    _grouped_attn_in,
    _quant_linear,
    _quant_mlp_grouped,
    _quant_mlp_grouped_full,
    _quant_swiglu,
    dequantize_kv,
    kron_transform,
    kron_transform_perm,
    quantize_kv_asym,
)
from flatquant_torch.utils import tracing

def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, mode: str = "bf16", n_blocks: int = 0,
               block_size: int = 256, device="cuda") -> dict:
    """KV cache, one zeroed tensor per layer, updated in place by every
    phase. mode="bf16": "k"/"v" [B, max_len, nkv, hd] in `dtype`
    (dequantized values). mode="int4": "kp"/"vp" [B, nkv, max_len, hd/2]
    uint8 and "kparam"/"vparam" [B, nkv, max_len, 2] float32 (scale,
    zero). mode="paged": the block pool of kernels/paged_kv.py
    (n_blocks=0 sizes it for batch x max_len plus the trash block 0) and
    "tbl" [B, ceil(max_len / block_size)] int32, JAX's static table: slot
    b holds contiguous blocks from 1 + b * n_per. `dtype` is used by
    "bf16" only."""
    if mode not in ("bf16", "int4", "paged"):
        raise ValueError(f"cache mode {mode!r}: 'bf16', 'int4' or 'paged'")
    dev = resolve_device(device)
    L, nkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if mode == "paged":
        mb = -(-max_len // block_size)
        if n_blocks <= 0:
            n_blocks = 1 + batch * mb
        pool = init_paged_pool(L, n_blocks, nkv, hd, block_size, dev)
        n_per = min(mb, (n_blocks - 1) // max(batch, 1))
        tbl = torch.zeros((batch, mb), dtype=torch.int32)
        for b in range(batch):
            tbl[b, :n_per] = 1 + b * n_per + torch.arange(n_per)
        pool["tbl"] = tbl.to(dev)
        return pool
    if mode == "bf16":
        return {key: [torch.zeros((batch, max_len, nkv, hd), dtype=dtype,
                                  device=dev) for _ in range(L)]
                for key in ("k", "v")}

    def zeros(last, dt):
        return [torch.zeros((batch, nkv, max_len, last), dtype=dt,
                            device=dev) for _ in range(L)]

    return {"kp": zeros(hd // 2, torch.uint8),
            "kparam": zeros(2, torch.float32),
            "vp": zeros(hd // 2, torch.uint8),
            "vparam": zeros(2, torch.float32)}


def _apply_head_matrix(t, mat):
    """t [..., h, d] @ mat [d, d], in mat's dtype."""
    return t.to(mat.dtype) @ mat


def _fused_attention(cfg, fq_cfg, sl, S, per_slot, phase, use_kernel,
                     tp_axis=None):
    """JAX's condition for the fused prefill attention
    (flatquant_tpu/serving/engine.py:409-414: the merged qkv, o_t (not
    the perm layout's o_tp), no tp)."""
    a_cfg = fq_cfg.a_cfg
    return (use_kernel and phase == "prefill" and "qkv" in sl
            and tp_axis is None
            and cfg.head_dim == 128
            and S % 128 == 0 and S >= 256 and not per_slot and "k_t" in sl
            and sl.get("o_t") is not None
            and sl["o_t"].shape[-1] == cfg.num_heads and "wp" in sl["o"]
            and a_cfg.enabled and a_cfg.q_max == 7)


def _check_ported(fq_cfg, sl, S, per_slot, phase, tp_axis=None):
    """Check the phase and the tp axis before any cache write."""
    if phase not in ("prefill", "decode", "chunk") or (
            phase == "decode" and S != 1):
        raise ValueError(f"phase {phase!r} with {S} tokens: 'prefill', "
                         "'chunk', or 'decode' of one token")
    if per_slot and phase != "decode":
        raise ValueError("per-slot positions only in single-token decode")
    if tp_axis is not None and not hasattr(tp_axis, "group"):
        raise TypeError(f"tp_axis {tp_axis!r}: a parallel/mesh.py Axis "
                        "(mesh.axis('tp')), not an axis name")


def _qlin(fq_cfg, h, lin, use_kernel, compute_dtype, bias=None, axis=None):
    """The quantized linear of h [..., K] -> [..., N] (+ bias): per-token
    quant and the quantized-weight GEMM, or the weight-only branch when
    activations are not quantized. axis: the tp Axis of a row-parallel
    linear, whose partial outputs are summed over its ranks (JAX's
    psum)."""
    y = _quant_linear(h.reshape(-1, h.shape[-1]), lin, use_kernel,
                      compute_dtype, quant_acts=fq_cfg.a_cfg.enabled,
                      a_q_max=fq_cfg.a_cfg.q_max, axis_name=axis)
    y = y.reshape(h.shape[:-1] + (lin["scale"].shape[0],))
    if axis is not None:
        y = all_reduce(y, "sum", axis)
    return y if bias is None else y + bias.to(y.dtype)


def _qkv(cfg, fq_cfg, sl, x, use_kernel, compute_dtype, tp_axis=None):
    """The attention input projections: the merged qkv [B, S, q_dim +
    2*kv_dim] (with use_kernel and quantized activations through the
    fused flat-pipeline input route where it qualifies, else RMSNorm, the
    Kronecker transform and the quantized linear), or, for an unmerged
    layer, the tuple (q, k, v) of three quantized linears. Under tp the
    fused route declines (its scales are shard-local)."""
    B, S, H = x.shape
    if use_kernel and fq_cfg.a_cfg.enabled and tp_axis is None:
        qkv_g = _grouped_attn_in(x.reshape(-1, H), sl, cfg.rms_eps,
                                 compute_dtype, fq_cfg.a_cfg.q_max)
        if qkv_g is not None:
            qkv = qkv_g.reshape(B, S, qkv_g.shape[-1])
            if sl.get("bqkv") is not None:
                qkv = qkv + sl["bqkv"].to(qkv.dtype)
            return qkv
    h = rms_norm(x, sl["ln1_w"], cfg.rms_eps)
    if "ln_tp" in sl:
        h = kron_transform_perm(h, sl["ln_tp"])
    elif "ln_t" in sl:
        h = kron_transform(h, sl["ln_t"])
    if "qkv" in sl:
        return _qlin(fq_cfg, h, sl["qkv"], use_kernel, compute_dtype,
                     sl.get("bqkv"))
    return tuple(_qlin(fq_cfg, h, sl[n], use_kernel, compute_dtype,
                       sl.get("b" + n)) for n in ("q", "k", "v"))


def _split_rope(cfg, sl, qkv, cos, sin, pos, per_slot):
    """Split qkv (or take an unmerged layer's (q, k, v)) into q [B, S, nh,
    hd], k, v [B, S, nkv, hd]; RoPE at positions [pos, pos + S) (or each
    slot's own position); k by k_t and q by k_t_inv into the cache's K
    space."""
    if isinstance(qkv, tuple):
        q, k, v = qkv
    else:
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim],
                              dim=-1)
    B, S = q.shape[:2]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if per_slot:
        cb = cos[pos][:, None, None, :]  # [B, 1, 1, d]
        sb = sin[pos][:, None, None, :]
        q = q * cb.to(q.dtype) + rotate_half(q) * sb.to(q.dtype)
        k = k * cb.to(k.dtype) + rotate_half(k) * sb.to(k.dtype)
    else:
        q, k = apply_rope(q, k, cos[pos:pos + S], sin[pos:pos + S])
    if "k_t" in sl:
        k = _apply_head_matrix(k, sl["k_t"])
        q = _apply_head_matrix(q, sl["k_t_inv"])
    return q, k, v


def _o_proj(cfg, fq_cfg, sl, x, attn, use_kernel, compute_dtype,
            tp_axis=None):
    """x plus the o projection of attn [B, S, nh, hd]: the o_t head mixing
    (einsum), the perm layout's o_tp head mixing ([.., g, hd]^T @ o_tp over
    the minor dim: (group, d, i) channel order, which the packed o weight
    was permuted to) or, without either, the v transform's inverse per
    head (v_t_inv), then the quantized o linear."""
    B, S = attn.shape[:2]
    if sl.get("o_tp") is not None:
        o_mat = sl["o_tp"].to(attn.dtype)
        g = o_mat.shape[0]
        attn = attn.reshape(B, S, cfg.num_heads // g, g,
                            cfg.head_dim).transpose(-2, -1) @ o_mat
    elif sl.get("o_t") is not None:
        o_mat = sl["o_t"].to(attn.dtype)
        g = o_mat.shape[0]
        attn = attn.reshape(B, S, cfg.num_heads // g, g, cfg.head_dim)
        attn = torch.einsum("ji,bstjd->bstid", o_mat, attn)
    elif sl.get("v_t_inv") is not None:
        attn = attn @ sl["v_t_inv"].T.to(attn.dtype)
    attn = attn.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return x + _qlin(fq_cfg, attn, sl["o"], use_kernel, compute_dtype,
                     axis=tp_axis)


def _cache_attention(q, ck, cv, pos, compute_dtype):
    """Attention of q [B, S, nh, hd] over a bf16 cache ck/cv
    [B, Smax, nkv, hd], row s seeing positions <= pos + s (pos an int, or
    a per-slot tensor [B]); plain tensor math, as in JAX: float32 scores
    divided by sqrt(hd) with a -1e9 bias, probs cast to compute_dtype
    before the PV product. Shared by serving_layer and the bf16
    comparator."""
    S, nh, hd = q.shape[1:]
    ids = torch.arange(ck.shape[1], device=q.device)[None, None, None]
    iq = torch.arange(S, device=q.device)[None, None, :, None]
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    limit = (pos.reshape(-1, 1, 1, 1) if per_slot else pos) + iq
    bias = torch.where(ids <= limit, 0.0, -1e9)
    n_rep = nh // ck.shape[2]
    k_att = ck.repeat_interleave(n_rep, dim=2) if n_rep > 1 else ck
    v_att = cv.repeat_interleave(n_rep, dim=2) if n_rep > 1 else cv
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute_dtype),
                          k_att.to(compute_dtype))
    scores = true_div(scores.to(torch.float32), float(np.sqrt(hd))) + bias
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_att.to(compute_dtype))


def serving_layer(cfg, fq_cfg, sl, x, cos, sin, ck, cv, pos, phase,
                  use_kernel, compute_dtype=torch.bfloat16, tp_axis=None,
                  attn_fn=None):
    """One quantized decoder layer over the bf16 cache (JAX
    engine.py:115-336).

    x [B, S, H]; ck/cv: this layer's cache [B, Smax, nkv, hd], written IN
    PLACE at [pos, pos + S) (per-slot decode: at each slot's position, by
    masked select). K/V go through quantize -> dequantize at write when
    their bits are < 16. Prefill attends with the unquantized K/V through
    `prefill_attention`; decode attends over the cache. Returns the layer
    output. tp_axis: see the module docstring. attn_fn(q, k, v, sm_scale)
    replaces the prefill attention (ring attention under sequence
    parallelism: the K/V just written are this rank's chunk)."""
    S = x.shape[1]
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    _check_ported(fq_cfg, sl, S, per_slot, phase, tp_axis)
    with tracing.span("qkv"):
        qkv = _qkv(cfg, fq_cfg, sl, x, use_kernel, compute_dtype, tp_axis)
    with tracing.span("kv_write"):
        q, k, v = _split_rope(cfg, sl, qkv, cos, sin, pos, per_slot)
        stores = []
        for t, bits_cfg, clip, cache in (
                (k, fq_cfg.k_cfg, sl.get("kc_clip"), ck),
                (v, fq_cfg.v_cfg, sl.get("vc_clip"), cv)):
            if bits_cfg.enabled:
                # serving KV is asymmetric, so the grid is 2^bits - 1
                # whatever the sym flag (as in JAX)
                tq, ts, tz = quantize_kv_asym(
                    t, clip, q_max=(1 << bits_cfg.bits) - 1)
                stores.append(dequantize_kv(tq, ts, tz, cache.dtype))
            else:
                stores.append(t.to(cache.dtype))
        for cache, new in zip((ck, cv), stores):
            if per_slot:
                row = torch.arange(cache.shape[1], device=x.device)
                hit = row[None, :, None, None] == pos[:, None, None, None]
                cache.copy_(torch.where(hit, new, cache))
            else:
                cache[:, pos:pos + S] = new

    sm_scale = 1.0 / float(np.sqrt(cfg.head_dim))
    with tracing.span("attn"):
        if phase == "prefill" and attn_fn is not None:
            attn = attn_fn(q, k, v, sm_scale).to(compute_dtype)
        elif phase == "prefill":
            attn = prefill_attention(q, k, v, sm_scale, use_kernel,
                                     compute_dtype)
        else:
            attn = _cache_attention(q, ck, cv, pos, compute_dtype)
    with tracing.span("o_proj"):
        x = _o_proj(cfg, fq_cfg, sl, x, attn, use_kernel, compute_dtype,
                    tp_axis)
    with tracing.span("mlp"):
        return _serving_mlp(cfg, fq_cfg, sl, x, use_kernel, compute_dtype,
                            tp_axis)


def serving_layer_int4cache(cfg, fq_cfg, sl, x, cos, sin, kp, kparam, vp,
                            vparam, pos, phase, use_kernel, compute_dtype,
                            tp_axis=None, tbl=None):
    """One quantized decoder layer over the packed int4 cache.

    x [B, S, H]; kp/kparam/vp/vparam: this layer's cache tensors (slot
    cache, or with `tbl` [B, mb] the block pool), written IN PLACE; pos:
    an int (the first position of x) or, in single-token decode, a
    per-slot tensor [B]. Prefill writes the quantized prompt K/V and
    attends unquantized; a chunk writes its K/V at [pos, pos + S) and
    attends over the cache (chunk_attention_int4 or, paged,
    paged_chunk_attention_int4); decode writes one token and attends over
    the cache through decode_attention_int4 or, paged,
    paged_decode_attention_int4. Returns the layer output. tp_axis: see
    the module docstring."""
    B, S, H = x.shape
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    _check_ported(fq_cfg, sl, S, per_slot, phase, tp_axis)
    with tracing.span("qkv"):
        qkv = _qkv(cfg, fq_cfg, sl, x, use_kernel, compute_dtype, tp_axis)

    if _fused_attention(cfg, fq_cfg, sl, S, per_slot, phase, use_kernel,
                        tp_axis):
        with tracing.span("attn_fused"):
            x = _fused_prefill_attention(cfg, fq_cfg, sl, x, qkv, cos, sin,
                                         kp, kparam, vp, vparam, pos,
                                         compute_dtype, tbl)
        with tracing.span("mlp"):
            return _serving_mlp(cfg, fq_cfg, sl, x, use_kernel,
                                compute_dtype)

    with tracing.span("kv_write"):
        q, k, v = _split_rope(cfg, sl, qkv, cos, sin, pos, per_slot)
        kq, kpar = pack_kv_token_major(k, sl.get("kc_clip"))  # [B, nkv, S, .]
        vq, vpar = pack_kv_token_major(v, sl.get("vc_clip"))
        if tbl is not None and phase == "prefill":
            assert pos == 0, "a paged prefill starts at position 0"
            write_prompt_paged(kp, kparam, kq, kpar, tbl)
            write_prompt_paged(vp, vparam, vq, vpar, tbl)
        elif tbl is not None and phase == "chunk":
            write_chunk_paged(kp, kparam, kq, kpar, tbl, pos)
            write_chunk_paged(vp, vparam, vq, vpar, tbl, pos)
        elif tbl is not None:
            pos_vec = (pos if per_slot
                       else torch.full((B,), pos, device=x.device))
            write_token_paged(kp, kparam, kq[:, :, 0], kpar[:, :, 0], tbl,
                              pos_vec)
            write_token_paged(vp, vparam, vq[:, :, 0], vpar[:, :, 0], tbl,
                              pos_vec)
        elif per_slot:
            put = write_token if use_kernel else write_token_ref
            put(kp, kparam, vp, vparam, kq, kpar, vq, vpar, pos)
        else:
            kp[:, :, pos:pos + S] = kq
            kparam[:, :, pos:pos + S] = kpar
            vp[:, :, pos:pos + S] = vq
            vparam[:, :, pos:pos + S] = vpar

    sm_scale = 1.0 / float(np.sqrt(cfg.head_dim))
    with tracing.span("attn"):
        if phase == "prefill":
            attn = prefill_attention(q, k, v, sm_scale, use_kernel,
                                     compute_dtype)
        elif phase == "chunk":
            pos_vec = torch.full((B,), pos, dtype=torch.int32,
                                 device=x.device)
            if tbl is not None:
                chunk_fn = (paged_chunk_attention_int4 if use_kernel
                            else paged_chunk_attention_ref)
                attn = chunk_fn(q, kp, kparam, vp, vparam, tbl, pos_vec,
                                sm_scale).to(compute_dtype)
            elif use_kernel:
                attn = chunk_attention_int4(q, kp, kparam, vp, vparam,
                                            pos_vec, sm_scale
                                            ).to(compute_dtype)
            else:
                # JAX's chain casts its float32 result to compute_dtype
                # directly (engine.py:538-560), not through q's dtype
                attn = chunk_scores_ref(q, kp, kparam, vp, vparam, pos,
                                        sm_scale).to(compute_dtype)
        else:
            if per_slot:
                valid = (pos + 1).to(torch.int32)
            else:
                valid = torch.full((B,), pos + 1, dtype=torch.int32,
                                   device=x.device)
            if tbl is not None:
                paged_fn = (paged_decode_attention_int4 if use_kernel
                            else paged_decode_attention_ref)
                attn = paged_fn(q[:, 0], kp, kparam, vp, vparam, tbl, valid,
                                sm_scale)
            elif use_kernel:
                attn = decode_attention_int4(q[:, 0], kp, kparam, vp, vparam,
                                             valid, sm_scale)
            else:
                attn = decode_attention_ref(
                    q[:, 0], kp, kparam[..., 0:1], kparam[..., 1:2], vp,
                    vparam[..., 0:1], vparam[..., 1:2], valid, sm_scale)
            attn = attn[:, None]
    with tracing.span("o_proj"):
        x = _o_proj(cfg, fq_cfg, sl, x, attn, use_kernel, compute_dtype,
                    tp_axis)
    with tracing.span("mlp"):
        return _serving_mlp(cfg, fq_cfg, sl, x, use_kernel, compute_dtype,
                            tp_axis)


def _serving_mlp(cfg, fq_cfg, sl, x, use_kernel, compute_dtype,
                 tp_axis=None):
    """The MLP half of a serving layer (both cache modes): with use_kernel
    and quantized activations the fully fused flat pipeline
    (_quant_mlp_grouped_full) or its tail after an eager ln2
    (_quant_mlp_grouped) where they qualify; else the composed branch
    (eager ln2 + Kronecker glue (the perm form under ug_tp), the merged
    up||gate projection with silu (_quant_swiglu: the fused swiglu GEMM at
    256+ rows) or the unmerged up and gate linears, the down transform
    (down_tp: the perm form) and the down linear, all-reduced over
    tp_axis when given; the fused routes decline under tp)."""
    H = x.shape[-1]
    a_cfg = fq_cfg.a_cfg
    fused = use_kernel and a_cfg.enabled and tp_axis is None
    if fused:
        y_full = _quant_mlp_grouped_full(x.reshape(-1, H), sl, cfg.rms_eps,
                                         compute_dtype, a_cfg.q_max)
        if y_full is not None:
            return x + y_full.reshape(x.shape)
    h2 = rms_norm(x, sl["ln2_w"], cfg.rms_eps)
    if "ug_tp" in sl:
        h2 = kron_transform_perm(h2, sl["ug_tp"])
    elif "ug_t" in sl:
        h2 = kron_transform(h2, sl["ug_t"])
    if fused:
        y_mlp = _quant_mlp_grouped(h2.reshape(-1, H), sl, compute_dtype,
                                   a_cfg.q_max)
        if y_mlp is not None:
            return x + y_mlp.reshape(x.shape)
    if "upgate" in sl:
        act = _quant_swiglu(h2.reshape(-1, H), sl["upgate"], use_kernel,
                            compute_dtype, a_cfg.enabled, a_cfg.q_max)
        act = act.reshape(h2.shape[:-1] + (act.shape[-1],))
    else:
        up = _qlin(fq_cfg, h2, sl["up"], use_kernel, compute_dtype)
        gate = _qlin(fq_cfg, h2, sl["gate"], use_kernel, compute_dtype)
        act = silu(gate) * up
    if "down_tp" in sl:
        act = kron_transform_perm(act, sl["down_tp"])
    elif "down_t" in sl:
        act = kron_transform(act, sl["down_t"])
    return x + _qlin(fq_cfg, act, sl["down"], use_kernel, compute_dtype,
                     axis=tp_axis)


def _fused_prefill_attention(cfg, fq_cfg, sl, x, qkv, cos, sin, kp, kparam,
                             vp, vparam, pos, compute_dtype, tbl=None):
    """Prefill attention through the fused prologue and the fused o path
    (JAX engine.py:655-717). qkv: the merged projection output
    [B, S, (nh + 2*nkv)*128]. attn_prologue writes the packed int4 K/V
    into the cache tensors at [pos, pos + S) in place (with `tbl`, it
    returns fresh token-major codes that write_prompt_paged puts into the
    block pool); attention is
    unquantized: flash kt at S >= 1024 (the prologue's token-major k_rot
    passed as a strided [B, nkv, hd, S] view, no copy), dense below; the o
    head mixing + per-token quant is one left_quant_i8_flat pass (a left
    Kronecker factor o_t.T with identity right factor) on the
    bf16-rounded attention output. Returns x plus the o projection."""
    B, S, _ = qkv.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qf, kf, vf, kq, kpar, vq, vpar = attn_prologue(
        qkv, cos[pos:pos + S], sin[pos:pos + S], sl["k_t"], sl["k_t_inv"],
        sl.get("kc_clip"), sl.get("vc_clip"), nh=nh, nkv=nkv,
        cache=None if tbl is not None else (kp, kparam, vp, vparam), pos=pos)
    if tbl is not None:
        write_prompt_paged(kp, kparam, kq, kpar, tbl)
        write_prompt_paged(vp, vparam, vq, vpar, tbl)
    sm_scale = 1.0 / float(np.sqrt(hd))
    q4 = qf.reshape(B, S, nh, hd)
    k4 = kf.reshape(B, S, nkv, hd)
    v4 = vf.reshape(B, S, nkv, hd)
    if is_flash(S):
        attn = flash_prefill_attention_kt(q4, k4.permute(0, 2, 3, 1), v4,
                                          sm_scale)
    else:
        attn = dense_causal_attention(q4, k4, v4, sm_scale, compute_dtype)
    zq, zs = left_quant_i8_flat(
        sl["o_t"].T, attn.reshape(B * S, nh * hd).to(torch.bfloat16),
        clip=sl["o"].get("a_clip"), q_max=fq_cfg.a_cfg.q_max)
    y = w4a4_matmul_i8(zq, zs, sl["o"]["wp"], sl["o"]["scale"],
                       compute_dtype)
    return x + y.reshape(B, S, -1)


def _forward(cfg, fq_cfg, sp, tokens, cache, pos, phase, use_kernel, max_len,
             compute_dtype=torch.bfloat16, last_idx=None, tp_axis=None):
    """Embed, run every layer (cache updated in place; a paged cache's
    "tbl" goes to every layer and stays in the dict), final norm and
    lm_head on the last (or last_idx) token -> float32 logits [B, V]
    (under tp_axis, with the rank's local cfg and params: this rank's
    vocab block [B, V/tp] of the vocab-parallel head)."""
    with tracing.span("embed"):
        x = sp["embed"][tokens].to(compute_dtype)
    with tracing.span("rope_tables"):
        cos, sin = rope_tables(cfg, torch.arange(max_len, device=x.device))
    if "kp" in cache:
        if fq_cfg.k_cfg.bits != 4 or fq_cfg.v_cfg.bits != 4:
            raise ValueError(
                "the packed cache holds int4 nibbles; kv8/kv16 configs use "
                "the bf16 cache mode (kv8 quantizes at write there)")
        for i, sl in enumerate(sp["layers"]):
            with tracing.span("layer", i=i):
                x = serving_layer_int4cache(
                    cfg, fq_cfg, sl, x, cos, sin, cache["kp"][i],
                    cache["kparam"][i], cache["vp"][i], cache["vparam"][i],
                    pos, phase, use_kernel, compute_dtype, tp_axis=tp_axis,
                    tbl=cache.get("tbl"))
    else:
        for i, sl in enumerate(sp["layers"]):
            with tracing.span("layer", i=i):
                x = serving_layer(cfg, fq_cfg, sl, x, cos, sin,
                                  cache["k"][i], cache["v"][i], pos, phase,
                                  use_kernel, compute_dtype, tp_axis=tp_axis)
    with tracing.span("head"):
        x = rms_norm(x, sp["final_norm_w"], cfg.rms_eps)
        last = (x[:, -1] if last_idx is None
                else x[torch.arange(x.shape[0], device=x.device), last_idx])
        return (last @ sp["lm_head"].T.to(x.dtype)).to(torch.float32)


@torch.no_grad()
def serving_all_logits(cfg, fq_cfg, sp, tokens, use_kernel=False,
                       compute_dtype=torch.bfloat16, device="cuda"):
    """Full-sequence logits [B, S, V] float32 through the real-quant
    serving stack (prefill-phase serving_layer over the bf16 cache): the
    lm-eval loglikelihood / perplexity path over packed weights. JAX
    allocates a whole cache it then discards; the port gives every layer
    the same scratch pair [B, S, nkv, hd]."""
    dev = resolve_device(device)
    tokens = _as_tokens(tokens, dev)
    B, S = tokens.shape
    ck = torch.zeros((B, S, cfg.num_kv_heads, cfg.head_dim),
                     dtype=compute_dtype, device=dev)
    cv = torch.zeros_like(ck)
    x = sp["embed"][tokens].to(compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(S, device=dev))
    for sl in sp["layers"]:
        x = serving_layer(cfg, fq_cfg, sl, x, cos, sin, ck, cv, 0,
                          "prefill", use_kernel, compute_dtype)
    x = rms_norm(x, sp["final_norm_w"], cfg.rms_eps)
    return (x @ sp["lm_head"].T.to(x.dtype)).to(torch.float32)


def _as_tokens(tokens, dev):
    return torch.as_tensor(tokens, device=dev).to(torch.long)


@torch.no_grad()
def serving_prefill(cfg, fq_cfg, sp, tokens, cache, use_kernel=True,
                    max_len=2048, compute_dtype=torch.bfloat16,
                    device="cuda"):
    """Process the prompt tokens [B, S]; returns (last-token logits
    [B, V] float32, cache). The cache's tensors are written in place (the
    same dict is returned, for the JAX package's call shape)."""
    dev = resolve_device(device)
    tokens = _as_tokens(tokens, dev)
    logits = _forward(cfg, fq_cfg, sp, tokens, cache, 0, "prefill",
                      use_kernel, max_len, compute_dtype)
    return logits, cache


@torch.no_grad()
def serving_decode_step(cfg, fq_cfg, sp, token, cache, pos, use_kernel=True,
                        max_len=2048, compute_dtype=torch.bfloat16,
                        device="cuda"):
    """One decode step. token [B, 1]; pos: an int (every slot at the same
    length) or a per-slot tensor [B] (continuous batching). Returns
    (logits [B, V] float32, cache), the cache updated in place."""
    dev = resolve_device(device)
    token = _as_tokens(token, dev)
    if torch.is_tensor(pos) or isinstance(pos, np.ndarray):
        pos = torch.as_tensor(pos, device=dev)
        if pos.ndim == 0:
            pos = int(pos)
    logits = _forward(cfg, fq_cfg, sp, token, cache, pos, "decode",
                      use_kernel, max_len, compute_dtype)
    return logits, cache


def sample_token(logits, temperature: float = 0.0, generator=None):
    """Greedy (temperature 0) or temperature sampling -> [B, 1] int32."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(cfg: LlamaConfig, fq_cfg: FQConfig, sp: dict, prompt,
             max_new_tokens: int = 32, max_len: int = 2048,
             use_kernel: bool = True, temperature: float = 0.0, seed: int = 0,
             cache_mode: str = "bf16", compute_dtype=torch.bfloat16,
             device="cuda"):
    """Prefill `prompt` [B, S], then decode max_new_tokens tokens; greedy
    at temperature 0. Returns the generated tokens [B, max_new_tokens] as
    a numpy int32 array."""
    dev = resolve_device(device)
    prompt = _as_tokens(prompt, dev)
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_len, mode=cache_mode, device=dev,
                       dtype=compute_dtype if cache_mode == "bf16"
                       else torch.bfloat16)
    logits, cache = serving_prefill(cfg, fq_cfg, sp, prompt, cache,
                                    use_kernel, max_len, compute_dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = sample_token(logits, temperature, gen)
    out = []
    for i in range(max_new_tokens):
        out.append(tok)
        logits, cache = serving_decode_step(
            cfg, fq_cfg, sp, tok, cache, S + i, use_kernel, max_len,
            compute_dtype, dev)
        tok = sample_token(logits, temperature, gen)
    return torch.cat(out, dim=1).cpu().numpy()
