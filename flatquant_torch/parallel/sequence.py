"""Sequence parallelism: ring attention over an "sp" mesh axis (port of
flatquant_tpu/parallel/sequence.py).

Each rank holds a contiguous chunk of S/sp tokens. Every op of a decoder
layer but attention is per token (FlatQuant's activation quantizers are
per token), so it runs on the chunk as it is. Attention runs the ring
schedule: the rank's queries against the K/V chunk it holds, with an
online softmax in float32, then K and V move one hop around the ring
(send / recv, parallel/distributed.py `ring_shift`). The ring starts on
the diagonal chunk, so the running max is finite from the first step;
chunks from later positions are masked whole and add p = 0. K and V are
never all-gathered.

JAX computes ring attention in plain jnp, with no Pallas kernel; the port
computes it in plain torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.parallel.distributed import all_gather, ring_shift
from flatquant_torch.parallel.mesh import Mesh


def ring_attention(q, k, v, sm_scale: float, axis):
    """Causal ring attention over `axis` (a mesh Axis). q [B, Sl, nh, hd],
    k / v [B, Sl, nkv, hd]: this rank's chunk, global offset index * Sl.
    Returns [B, Sl, nh, hd] in q's dtype."""
    B, Sl, nh, hd = q.shape
    n_rep = nh // k.shape[2]
    n, idx = axis.size, axis.index
    dev = q.device

    def rep(t):
        return t.repeat_interleave(n_rep, dim=2) if n_rep > 1 else t

    qf = q.to(torch.float32) * sm_scale
    row_pos = idx * Sl + torch.arange(Sl, device=dev)[None, None, :, None]
    local = torch.arange(Sl, device=dev)[None, None, None, :]
    m = torch.full((B, nh, Sl, 1), -float("inf"), device=dev)
    l_sum = torch.zeros((B, nh, Sl, 1), device=dev)
    acc = torch.zeros((B, nh, Sl, hd), device=dev)
    kc, vc = k, v
    for t in range(n):
        # after t hops this rank holds the chunk that started on idx - t
        src = (idx - t) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, rep(kc).to(torch.float32))
        s = torch.where(row_pos >= src * Sl + local, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p,
                                        rep(vc).to(torch.float32))
        m = m_new
        if t < n - 1:
            kc, vc = ring_shift(kc, axis), ring_shift(vc, axis)
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _local_rows(tokens, mesh: Mesh, sp_axis: str, dp_axis: Optional[str]):
    sp = mesh.axis(sp_axis)
    tokens = torch.as_tensor(tokens, device=mesh.device).to(torch.long)
    if dp_axis is not None:
        tokens = tokens[mesh.axis(dp_axis).block(tokens.shape[0])]
    return tokens[:, sp.block(tokens.shape[1])], sp


@torch.no_grad()
def sp_serving_prefill(cfg: LlamaConfig, fq_cfg, sp: dict, tokens,
                       mesh: Mesh, use_kernel: bool = False,
                       compute_dtype=torch.float32, sp_axis: str = "sp",
                       dp_axis: Optional[str] = None):
    """The real-quant serving prefill with the sequence split over
    `sp_axis`: tokens [B, S] (the same on every rank), S % sp == 0; each
    rank runs the serving layers (bf16 cache) on its chunk, RoPE at the
    chunk's global positions, prefill attention through `ring_attention`.
    Returns (float32 logits [B, S/sp, V] of this rank's chunk, the rank's
    bf16-mode cache {"k", "v"}: per-layer [B, S/sp, nkv, hd], its chunk's
    quantize-at-write K/V). With dp_axis each dp rank takes its block of
    the batch. JAX returns the same blocks as one array sharded over sp."""
    from flatquant_torch.models.llama import rms_norm, rope_tables
    from flatquant_torch.serving.engine import init_cache, serving_layer

    S = torch.as_tensor(tokens).shape[1]
    tok, axis = _local_rows(tokens, mesh, sp_axis, dp_axis)
    B, Sl = tok.shape
    cache = init_cache(cfg, B, Sl, dtype=compute_dtype, mode="bf16",
                       device=mesh.device)
    x = sp["embed"][tok].to(compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(S, device=mesh.device))
    block = axis.block(S)
    cos, sin = cos[block], sin[block]

    def attn(q, k, v, sm_scale):
        return ring_attention(q, k, v, sm_scale, axis)

    for i, sl in enumerate(sp["layers"]):
        # pos 0: the writes land at the top of the local shard; RoPE
        # comes from the global-offset tables above
        x = serving_layer(cfg, fq_cfg, sl, x, cos, sin, cache["k"][i],
                          cache["v"][i], 0, "prefill", use_kernel,
                          compute_dtype, attn_fn=attn)
    x = rms_norm(x, sp["final_norm_w"], cfg.rms_eps)
    logits = (x @ sp["lm_head"].T.to(x.dtype)).to(torch.float32)
    return logits, cache


@torch.no_grad()
def sp_gather_cache_for_decode(cfg: LlamaConfig, cache: dict, mesh: Mesh,
                               max_len: int, mode: str = "bf16",
                               sp_axis: str = "sp"):
    """The prefill -> decode handoff: sp_serving_prefill's chunked cache
    all-gathered over `sp_axis` into a whole cache on every rank, padded
    to max_len. mode "bf16": the slot cache {"k", "v"} [B, max_len, nkv,
    hd] per layer, from which serving_decode_step continues exactly as
    after a single-device prefill. mode "int4": the rows re-packed into
    the packed int4 cache (pack_kv_token_major, no clip: the rows are
    already on the int4 grid), codes equal to the slot path's up to
    re-quantization rounding of grid values."""
    from flatquant_torch.kernels.kv_cache import pack_kv_token_major

    axis = mesh.axis(sp_axis)
    ks = [all_gather(t, 1, axis) for t in cache["k"]]
    vs = [all_gather(t, 1, axis) for t in cache["v"]]
    S = ks[0].shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens > max_len {max_len}")

    def pad(t, dim):
        shape = list(t.shape)
        shape[dim] = max_len - S
        return torch.cat([t, t.new_zeros(shape)], dim=dim)

    if mode == "bf16":
        return {"k": [pad(t, 1) for t in ks], "v": [pad(t, 1) for t in vs]}
    if mode != "int4":
        raise ValueError(f"handoff mode {mode!r}: 'bf16' or 'int4'")
    out = {"kp": [], "kparam": [], "vp": [], "vparam": []}
    for k, v in zip(ks, vs):
        for name, t in (("k", k), ("v", v)):
            codes, params = pack_kv_token_major(t)
            out[name + "p"].append(pad(codes, 2))
            out[name + "param"].append(pad(params, 2))
    return out


@torch.no_grad()
def sp_llama_forward(cfg: LlamaConfig, params: dict, tokens, mesh: Mesh,
                     fq=None, fq_cfg=None, mode: str = "fp",
                     compute_dtype=torch.float32, sp_axis: str = "sp",
                     dp_axis: Optional[str] = None):
    """models.llama.llama_forward with the sequence split over `sp_axis`:
    tokens [B, S] (the same on every rank), S % sp == 0; weights and FQ
    state replicated. Returns float32 logits [B, S/sp, V] of this rank's
    chunk (with dp_axis, of its batch block): llama_forward's values up to
    the softmax's summation order."""
    from flatquant_torch.models.llama import llama_forward

    tok, axis = _local_rows(tokens, mesh, sp_axis, dp_axis)
    Sl = tok.shape[1]
    sm_scale = 1.0 / float(np.sqrt(cfg.head_dim))
    positions = axis.index * Sl + torch.arange(Sl, device=mesh.device)

    def attn(q, k, v):
        return ring_attention(q, k, v, sm_scale, axis)

    return llama_forward(cfg, params, tok, fq=fq, fq_cfg=fq_cfg, mode=mode,
                         compute_dtype=compute_dtype, positions=positions,
                         attn_fn=attn)
