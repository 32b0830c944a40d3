"""Functional Llama-family transformer (Llama-2/3/3.1, Qwen-2.5) with
FlatQuant's forward modes (port of flatquant_tpu/models/llama.py).

  - "fp":    the plain full-precision forward (the teacher path)
  - "calib": transforms + STE fake-quant threaded through every linear
             (the reference's _train_forward, llama_utils.py:163-286)
  - "eval":  weights already baked (quantize/bake.py); only activation
             quant and the baked activation-side transforms run

Parameters are plain dicts of tensors; "layers" is a Python list with one
dict per layer, and the FQ state a list of LayerFQ (JAX stacks both on a
leading axis for lax.scan). Weight layout is [out_features,
in_features]; matmuls are x @ W^T.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flatquant_torch.core.quant import act_fake_quant
from flatquant_torch.core.transforms import (
    apply_decompose,
    apply_single,
    single_matrix,
)
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.parallel.distributed import all_gather
from flatquant_torch.parallel.tp_autograd import (
    active,
    copy_to,
    copy_tree,
    gather_from,
    reduce_from,
    row_reducer,
    scatter_to,
)
from flatquant_torch.quantize.linear import (
    LinearQuantState,
    fq_linear_eval,
    fq_linear_train,
)
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.utils import tracing

MODES = ("fp", "calib", "eval")


def init_layer_params(cfg: LlamaConfig, generator: torch.Generator,
                      dtype=torch.float32, device="cuda") -> dict:
    """One decoder layer's random weights, N(0, 0.02^2), drawn from
    `generator` (which must live on `device`)."""
    dev = resolve_device(device)
    H, I = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)

    lp = {
        "ln1_w": torch.ones(H, dtype=dtype, device=dev),
        "ln2_w": torch.ones(H, dtype=dtype, device=dev),
        "wq": w(cfg.q_dim, H),
        "wk": w(cfg.kv_dim, H),
        "wv": w(cfg.kv_dim, H),
        "wo": w(H, cfg.q_dim),
        "wgate": w(I, H),
        "wup": w(I, H),
        "wdown": w(H, I),
    }
    if cfg.attn_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            lp[name] = torch.zeros(n, dtype=dtype, device=dev)
    return lp


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random-weight model from a seeded torch.Generator on `device`.
    (The JAX package draws other numbers from the same seed; tests hand
    both packages numpy-made weights instead.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)

    params = {
        "layers": [init_layer_params(cfg, gen, dtype, dev)
                   for _ in range(cfg.num_layers)],
        "embed": w(cfg.vocab_size, cfg.hidden_size),
        "final_norm_w": torch.ones(cfg.hidden_size, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w(cfg.vocab_size, cfg.hidden_size)
    return params


def rms_norm(x, w, eps: float):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


def _rope_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Inverse frequencies in float64 (numpy), with Llama-3.1 banded
    scaling when the config has it; callers cast to float32."""
    inv_freq = 1.0 / (cfg.rope_theta ** (
        np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
    rs = cfg.rope_scaling
    if rs is not None:
        low_wavelen = rs.original_max_position_embeddings / rs.low_freq_factor
        high_wavelen = rs.original_max_position_embeddings / rs.high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = inv_freq / rs.factor
        smooth = (rs.original_max_position_embeddings / wavelen
                  - rs.low_freq_factor) / (rs.high_freq_factor
                                           - rs.low_freq_factor)
        mid = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(wavelen < high_wavelen, inv_freq,
                            np.where(wavelen > low_wavelen, scaled, mid))
    return inv_freq


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables [S, head_dim] (float32), HF half-rotation
    convention."""
    with tracing.sync("h2d.rope_inv_freq"):
        inv_freq = torch.as_tensor(_rope_inv_freq(cfg), dtype=torch.float32,
                                   device=positions.device)
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def silu(x):
    """jax.nn.silu's own definition, x * (1 / (1 + exp(-x))), one rounding
    per op in x's dtype: in bf16 it then matches JAX bit for bit, where
    F.silu (one rounding at the end) differs by an ulp on a third of the
    elements."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: [B, S, h, d]; cos/sin: [S, d] (broadcast over batch/heads)."""
    cos = cos[None, :, None, :].to(q.dtype)
    sin = sin[None, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def _head_cfg(cfg_act, head_dim: int):
    """Per-head cache quant: a group covering >= head_dim degrades to per
    (token, head) over head_dim."""
    if cfg_act.group_size <= 0 or cfg_act.group_size >= head_dim:
        return dataclasses.replace(cfg_act, group_size=-1)
    return cfg_act


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------


def _attention_core(cfg: LlamaConfig, q, k, v, mask):
    """Eager attention with a float32 softmax. q [B, S, nh, d], k / v
    [B, S, nkv, d]; scores divided by sqrt(d) in q's dtype, as JAX."""
    n_rep = cfg.num_heads // cfg.num_kv_heads
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    root = torch.sqrt(torch.full((), float(cfg.head_dim),
                                 dtype=torch.float32, device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root.to(q.dtype)
    scores = scores.to(torch.float32) + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _absmax(t):
    return t.to(torch.float32).abs().amax(dim=tuple(range(t.dim() - 1)))


def _fq_linear(fq_cfg, mode, quant, h, w, b, st, qa_trans=None,
               out_trans=None, axis=None):
    """One linear of the layer: plain without quantization, else the
    calib (fake-quant weight and activation) or eval (act quant) linear;
    axis: the tp Axis a row-parallel linear's in features are split over
    (its quantizers then reduce each row across the shards)."""
    if not quant:
        y = h @ w.T.to(h.dtype)
        return y + b.to(y.dtype) if b is not None else y
    if mode == "calib":
        return fq_linear_train(h, w, b, st, fq_cfg.w_cfg, fq_cfg.a_cfg,
                               qa_trans=qa_trans, out_trans=out_trans,
                               lwc=fq_cfg.lwc, row_reduce=row_reducer(axis))
    return fq_linear_eval(h, w, b, st, fq_cfg.a_cfg,
                          row_reduce=row_reducer(axis))


def _opt(fn, t):
    return None if t is None else fn(t)


def _local_state(st: Optional[LinearQuantState], tp, rows: bool):
    """A linear's clips as this rank's block of compute reads them: the
    activation clips copied in; the weight clips [out, 1] cut to this
    rank's rows for a column-parallel weight (rows=True), else copied
    (a row-parallel weight keeps every row)."""
    if st is None:
        return None
    cw = (lambda t: scatter_to(t, 0, tp)) if rows else \
        (lambda t: copy_to(t, tp))
    return LinearQuantState(
        clip_w_max=_opt(cw, st.clip_w_max), clip_w_min=_opt(cw, st.clip_w_min),
        clip_a_max=_opt(lambda t: copy_to(t, tp), st.clip_a_max),
        clip_a_min=_opt(lambda t: copy_to(t, tp), st.clip_a_min))


def _local_decompose(t, n_local: int, tp):
    """A Kronecker transform of n_local channels (shard-aligned state)
    applied to this rank's block: its factors copied in; a diag of
    n_local channels copied, one of n_local * tp (the sq-style init
    writes the full width) cut to this rank's block."""
    if t is None or not active(tp):
        return t
    diag = t.diag_scale
    body = copy_tree(dataclasses.replace(t, diag_scale=None), tp)
    if diag is not None:
        if diag.shape[0] == n_local:
            diag = copy_to(diag, tp)
        elif diag.shape[0] == n_local * tp.size:
            diag = scatter_to(diag, 0, tp)
        else:
            raise ValueError(f"a diag of {diag.shape[0]} channels on a "
                             f"block of {n_local}")
    return dataclasses.replace(body, diag_scale=diag)


def llama_layer(cfg: LlamaConfig, fq_cfg: Optional[FQConfig], mode: str,
                lp: dict, fq, x, cos, sin, mask, with_stats: bool = False,
                with_linear_inputs: bool = False, attn_fn=None,
                tp_axis=None):
    """One decoder layer. lp: this layer's params; fq: its LayerFQ (raw in
    "calib", baked in "eval", ignored in "fp").

    with_stats (fp mode): also return the per-channel absmax of the three
    quantized-linear inputs {ln, up, down} (the sq-style diag init's
    statistics). with_linear_inputs (eval mode): also return the
    pre-act-quant inputs of the four linear groups {qkv, o, upgate, down}
    (the GPTQ capture points), full width on every rank under tp (o and
    down gathered). attn_fn(q, k, v) replaces the eager attention core,
    same [B, S, nh|nkv, hd] contract (the sequence-parallel ring,
    parallel/sequence.py), this rank's heads under tp; `mask` is then
    unused.

    tp_axis: the mesh Axis lp is split over by llama_param_specs (x
    replicated over it), the collectives written out
    (parallel/tp_autograd.py): q / k / v / up / gate column-parallel on
    the replicated input, o / down row-parallel with their partial sums
    all-reduced. The per-token quantizer of a row-parallel input and the
    LWC and scales of a row-parallel weight take cross-shard extrema. An
    o / down transform as wide as the whole dim (tp = 1 state) mixes the
    shards: its input is gathered and that linear runs whole on every
    rank, as GSPMD runs it; shard-aligned state (init_model_fq(tp=...))
    applies block by block with no collective. wq / wo or wk / wv
    replicated by the head-granular rule run whole. with_stats gathers
    "down" to its full width. Without the axis every collective is the
    identity."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    tp = tp_axis if active(tp_axis) else None
    B, S, _ = x.shape
    hd = cfg.head_dim
    quant = mode != "fp" and fq is not None and fq_cfg is not None
    calib = quant and mode == "calib"
    nh_l = lp["wq"].shape[0] // hd
    q_split = nh_l < cfg.num_heads
    kv_split = lp["wk"].shape[0] // hd < cfg.num_kv_heads
    I_l = lp["wup"].shape[0]
    stats, captures = {}, {}

    def linear(h, w, b, st, qa=None, out_trans=None, axis=None):
        return _fq_linear(fq_cfg, mode, quant, h, w, b, st, qa, out_trans,
                          axis)

    def reg(t, split):
        """t as the compute of a split (this rank's block) or replicated
        region reads it."""
        return copy_tree(t, tp) if split else t

    # ---- attention ----
    h = rms_norm(x, lp["ln1_w"], cfg.rms_eps)
    if with_stats:
        stats["ln"] = _absmax(h)
    a = fq.attn if quant else None
    ln_trans = a.ln_trans if quant else None
    if ln_trans is not None:
        h = apply_decompose(ln_trans, h)
    if with_linear_inputs:
        captures["qkv"] = h
    qa = ln_trans if calib else None
    out_v = a.vcache_trans if calib and not fq_cfg.separate_vtrans else None
    h_l, qa_l = copy_to(h, tp), copy_tree(qa, tp)

    def col(w, b, st, out_trans, split):
        if split:
            return linear(h_l, w, b, _local_state(st, tp, True), qa_l,
                          copy_tree(out_trans, tp))
        return linear(h, w, b, st, qa, out_trans)

    q = col(lp["wq"], lp.get("bq"), a.q_lin if quant else None, None,
            q_split)
    k = col(lp["wk"], lp.get("bk"), a.k_lin if quant else None, None,
            kv_split)
    v = col(lp["wv"], lp.get("bv"), a.v_lin if quant else None, out_v,
            kv_split)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    q, k = apply_rope(q, k, cos, sin)

    def cache_quant(t, qcfg, cache, split):
        if not qcfg.enabled:
            return t
        c = reg(cache, split)
        return act_fake_quant(t, _head_cfg(qcfg, hd), c.clip_a_max,
                              c.clip_a_min)

    if quant:
        # K/Q rotation and cache fake-quant, post-RoPE
        kc = a.kcache_trans
        if kc is not None:
            q = apply_single(reg(kc, q_split), q, inv_t=True)
            k = apply_single(reg(kc, kv_split), k)
        q = cache_quant(q, fq_cfg.q_cfg, a.q_cache, q_split)
        k = cache_quant(k, fq_cfg.k_cfg, a.k_cache, kv_split)
        if fq_cfg.separate_vtrans and a.vcache_trans is not None:
            v = apply_single(reg(a.vcache_trans, kv_split), v)
        v = cache_quant(v, fq_cfg.v_cfg, a.v_cache, kv_split)
    lcfg = cfg
    if q_split:
        if not kv_split:
            # the replicated kv heads of this rank's q heads
            n_rep = cfg.num_heads // cfg.num_kv_heads
            blk = tp.block(cfg.num_heads)
            k = copy_to(k, tp).repeat_interleave(n_rep, dim=2)[:, :, blk]
            v = copy_to(v, tp).repeat_interleave(n_rep, dim=2)[:, :, blk]
        lcfg = dataclasses.replace(cfg, num_heads=q.shape[2],
                                   num_kv_heads=k.shape[2])
    if attn_fn is None:
        attn = _attention_core(lcfg, q, k, v, mask)
    else:
        attn = attn_fn(q, k, v)

    o_whole = not q_split  # o's input and weight whole on every rank
    if quant and a.o_trans is not None:
        # per-head mixing on the output: contraction over the heads axis
        g = a.o_trans.size
        if q_split and g != nh_l:  # spans every rank's heads
            attn = gather_from(attn, 2, tp)
            o_whole = True
        o_mat = single_matrix(reg(a.o_trans, not o_whole)).to(attn.dtype)
        nh_x = attn.shape[2]
        attn = attn.reshape(B, S, nh_x // g, g, hd)
        attn = torch.einsum("ji,bstjd->bstid", o_mat, attn)
        attn = attn.reshape(B, S, nh_x, hd)
    elif quant and a.vcache_trans is not None:
        # KV-only quant: undo the V transform fused into v_proj
        v_inv = single_matrix(reg(a.vcache_trans, q_split), inv_t=True)
        attn = attn @ v_inv.T.to(attn.dtype)
    attn = attn.reshape(B, S, -1)
    if with_linear_inputs:
        captures["o"] = attn if o_whole else gather_from(attn, -1, tp)
    qa_o = None
    if calib and a.o_trans is not None and a.vcache_trans is not None:
        qa_o = (single_matrix(reg(a.o_trans, not o_whole), inv_t=True),
                single_matrix(reg(a.vcache_trans, not o_whole), inv_t=True))
    o_st = a.o_lin if quant else None
    if o_whole:
        wo = lp["wo"] if not q_split else all_gather(lp["wo"], 1, tp)
        y = linear(attn, wo, None, o_st, qa_o)
    else:
        y = reduce_from(linear(attn, lp["wo"], None,
                               _local_state(o_st, tp, False), qa_o, axis=tp),
                        tp)
    x = x + y

    # ---- mlp ----
    h2 = rms_norm(x, lp["ln2_w"], cfg.rms_eps)
    if with_stats:
        stats["up"] = _absmax(h2)
    m = fq.mlp if quant else None
    ug = m.up_gate_trans if quant else None
    if ug is not None:
        h2 = apply_decompose(ug, h2)
    if with_linear_inputs:
        captures["upgate"] = h2
    h2_l, qa2_l = copy_to(h2, tp), copy_tree(ug if calib else None, tp)
    up = linear(h2_l, lp["wup"], None,
                _local_state(m.up_lin if quant else None, tp, True), qa2_l)
    gate = linear(h2_l, lp["wgate"], None,
                  _local_state(m.gate_lin if quant else None, tp, True),
                  qa2_l)
    act = silu(gate) * up
    if with_stats:
        stats["down"] = (all_gather(_absmax(act), 0, tp) if tp is not None
                         else _absmax(act))
    dt = m.down_trans if quant else None
    # a transform that spans every rank's block (one device applies a
    # narrower, shard-aligned one block-diagonally itself)
    d_whole = tp is not None and dt is not None and dt.size != I_l
    if d_whole:
        act = gather_from(act, -1, tp)
    else:
        dt = _local_decompose(dt, I_l, tp)
    if dt is not None:
        act = apply_decompose(dt, act)
    if with_linear_inputs:
        captures["down"] = act if d_whole or tp is None else \
            gather_from(act, -1, tp)
    qa3 = dt if calib else None
    d_st = m.down_lin if quant else None
    if d_whole:
        y = linear(act, all_gather(lp["wdown"], 1, tp), None, d_st, qa3)
    else:
        y = reduce_from(linear(act, lp["wdown"], None,
                               _local_state(d_st, tp, False), qa3, axis=tp),
                        tp)
    out = x + y
    if with_stats:
        return out, stats
    if with_linear_inputs:
        return out, captures
    return out


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def causal_mask(S: int, device="cuda"):
    """[1, 1, S, S] float32: 0 on and below the diagonal, -1e9 above."""
    keep = torch.ones((S, S), dtype=torch.bool,
                      device=resolve_device(device)).tril()
    return torch.where(keep, 0.0, -1e9)[None, None].to(torch.float32)


def embed_lookup(embed, tokens, vocab_size: int, tp_axis=None):
    """embed[tokens]; with a vocab-parallel table (this rank's rows of
    the vocab over tp_axis), a masked lookup of the rank's rows and an
    all-reduce (every token's row comes from one rank, so the sum is
    exact)."""
    if not active(tp_axis) or embed.shape[0] == vocab_size:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - tp_axis.index * rows
    ok = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)]
    return reduce_from(torch.where(ok[..., None], x, 0.0).to(embed.dtype),
                       tp_axis)


def llama_forward(cfg: LlamaConfig, params: dict, tokens, fq=None,
                  fq_cfg: Optional[FQConfig] = None, mode: str = "fp",
                  compute_dtype=torch.bfloat16, positions=None,
                  attn_fn=None, tp_axis=None, dp_axis=None):
    """Full forward over tokens [B, S] -> float32 logits [B, S, V], on the
    device that holds params. fq: the list of LayerFQ (None in "fp").
    attn_fn: a replacement for the eager attention core (the
    sequence-parallel ring); `positions` then carries the global
    positions of this shard's tokens and no causal mask is built.

    Under a mesh (JAX's sharded forward): params are this rank's blocks
    by llama_param_specs over tp_axis (a mesh Axis), fq replicated;
    dp_axis splits the batch, each rank running its block of rows. The
    vocab-parallel head's logits are gathered over tp and the rows over
    dp, so every rank returns the whole [B, S, V]."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    if active(dp_axis):
        tokens = tokens[dp_axis.block(tokens.shape[0])]
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg.vocab_size,
                     tp_axis).to(compute_dtype)
    if positions is None:
        positions = torch.arange(S, device=dev)
    cos, sin = rope_tables(cfg, torch.as_tensor(positions, device=dev))
    mask = None if attn_fn is not None else causal_mask(S, dev)
    fqs = fq if fq is not None else [None] * len(params["layers"])
    for lp, lfq in zip(params["layers"], fqs):
        x = llama_layer(cfg, fq_cfg, mode, lp, lfq, x, cos, sin, mask,
                        attn_fn=attn_fn, tp_axis=tp_axis)
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    if active(tp_axis) and head.shape[0] < cfg.vocab_size:
        logits = gather_from(copy_to(x, tp_axis) @ head.T.to(x.dtype), -1,
                             tp_axis)
    else:
        logits = x @ head.T.to(x.dtype)
    return gather_from(logits.to(torch.float32), 0, dp_axis)


def hidden_states_fn(cfg: LlamaConfig, params: dict, tokens,
                     compute_dtype=torch.bfloat16):
    """Embedding output, rope tables and causal mask: the calibration
    capture path (the reference's Catcher)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(S, device=dev))
    return x, cos, sin, causal_mask(S, dev)
