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
from flatquant_torch.quantize.linear import fq_linear_eval, fq_linear_train
from flatquant_torch.quantize.spec import FQConfig

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


def llama_layer(cfg: LlamaConfig, fq_cfg: Optional[FQConfig], mode: str,
                lp: dict, fq, x, cos, sin, mask, with_stats: bool = False,
                with_linear_inputs: bool = False, attn_fn=None):
    """One decoder layer. lp: this layer's params; fq: its LayerFQ (raw in
    "calib", baked in "eval", ignored in "fp").

    with_stats (fp mode): also return the per-channel absmax of the three
    quantized-linear inputs {ln, up, down} (the sq-style diag init's
    statistics). with_linear_inputs (eval mode): also return the
    pre-act-quant inputs of the four linear groups {qkv, o, upgate, down}
    (the GPTQ capture points). attn_fn(q, k, v) replaces the eager
    attention core, same [B, S, nh|nkv, hd] contract (the
    sequence-parallel ring, parallel/sequence.py); `mask` is then
    unused."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    B, S, _ = x.shape
    quant = mode != "fp" and fq is not None and fq_cfg is not None
    stats, captures = {}, {}

    def _absmax(t):
        return t.to(torch.float32).abs().amax(dim=tuple(range(t.dim() - 1)))

    def linear(h, w, b, lin_st, qa_trans=None, out_trans=None):
        if not quant:
            y = h @ w.T.to(h.dtype)
            return y + b.to(y.dtype) if b is not None else y
        if mode == "calib":
            return fq_linear_train(h, w, b, lin_st, fq_cfg.w_cfg,
                                   fq_cfg.a_cfg, qa_trans=qa_trans,
                                   out_trans=out_trans, lwc=fq_cfg.lwc)
        return fq_linear_eval(h, w, b, lin_st, fq_cfg.a_cfg)

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
    qa = ln_trans if mode == "calib" else None
    out_v = None
    if mode == "calib" and a is not None and not fq_cfg.separate_vtrans:
        out_v = a.vcache_trans
    q = linear(h, lp["wq"], lp.get("bq"), a.q_lin if quant else None,
               qa_trans=qa)
    k = linear(h, lp["wk"], lp.get("bk"), a.k_lin if quant else None,
               qa_trans=qa)
    v = linear(h, lp["wv"], lp.get("bv"), a.v_lin if quant else None,
               qa_trans=qa, out_trans=out_v)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    if quant:
        # K/Q rotation and cache fake-quant, post-RoPE
        if a.kcache_trans is not None:
            q = apply_single(a.kcache_trans, q, inv_t=True)
            k = apply_single(a.kcache_trans, k)
        hd = cfg.head_dim
        if fq_cfg.q_cfg.enabled:
            q = act_fake_quant(q, _head_cfg(fq_cfg.q_cfg, hd),
                               a.q_cache.clip_a_max, a.q_cache.clip_a_min)
        if fq_cfg.k_cfg.enabled:
            k = act_fake_quant(k, _head_cfg(fq_cfg.k_cfg, hd),
                               a.k_cache.clip_a_max, a.k_cache.clip_a_min)
        if fq_cfg.separate_vtrans and a.vcache_trans is not None:
            v = apply_single(a.vcache_trans, v)
        if fq_cfg.v_cfg.enabled:
            v = act_fake_quant(v, _head_cfg(fq_cfg.v_cfg, hd),
                               a.v_cache.clip_a_max, a.v_cache.clip_a_min)

    if attn_fn is None:
        attn = _attention_core(cfg, q, k, v, mask)
    else:
        attn = attn_fn(q, k, v)

    if quant and a.o_trans is not None:
        # per-head mixing on the output: contraction over the heads axis
        o_mat = single_matrix(a.o_trans).to(attn.dtype)
        g = o_mat.shape[0]
        attn = attn.reshape(B, S, cfg.num_heads // g, g, cfg.head_dim)
        attn = torch.einsum("ji,bstjd->bstid", o_mat, attn)
        attn = attn.reshape(B, S, cfg.num_heads, cfg.head_dim)
    elif quant and a.vcache_trans is not None:
        # KV-only quant: undo the V transform fused into v_proj
        v_inv = single_matrix(a.vcache_trans, inv_t=True).to(attn.dtype)
        attn = attn @ v_inv.T
    attn = attn.reshape(B, S, cfg.q_dim)
    if with_linear_inputs:
        captures["o"] = attn
    qa_o = None
    if (mode == "calib" and a is not None and a.o_trans is not None
            and a.vcache_trans is not None):
        qa_o = (single_matrix(a.o_trans, inv_t=True),
                single_matrix(a.vcache_trans, inv_t=True))
    x = x + linear(attn, lp["wo"], None, a.o_lin if quant else None,
                   qa_trans=qa_o)

    # ---- mlp ----
    h2 = rms_norm(x, lp["ln2_w"], cfg.rms_eps)
    if with_stats:
        stats["up"] = _absmax(h2)
    m = fq.mlp if quant else None
    ug_trans = m.up_gate_trans if quant else None
    if ug_trans is not None:
        h2 = apply_decompose(ug_trans, h2)
    if with_linear_inputs:
        captures["upgate"] = h2
    qa2 = ug_trans if mode == "calib" else None
    up = linear(h2, lp["wup"], None, m.up_lin if quant else None,
                qa_trans=qa2)
    gate = linear(h2, lp["wgate"], None, m.gate_lin if quant else None,
                  qa_trans=qa2)
    act = silu(gate) * up
    if with_stats:
        stats["down"] = _absmax(act)
    down_trans = m.down_trans if quant else None
    if down_trans is not None:
        act = apply_decompose(down_trans, act)
    if with_linear_inputs:
        captures["down"] = act
    qa3 = down_trans if mode == "calib" else None
    out = x + linear(act, lp["wdown"], None, m.down_lin if quant else None,
                     qa_trans=qa3)
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


def llama_forward(cfg: LlamaConfig, params: dict, tokens, fq=None,
                  fq_cfg: Optional[FQConfig] = None, mode: str = "fp",
                  compute_dtype=torch.bfloat16, positions=None,
                  attn_fn=None):
    """Full forward over tokens [B, S] -> float32 logits [B, S, V], on the
    device that holds params. fq: the list of LayerFQ (None in "fp").
    attn_fn: a replacement for the eager attention core (the
    sequence-parallel ring); `positions` then carries the global
    positions of this shard's tokens and no causal mask is built."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(compute_dtype)
    if positions is None:
        positions = torch.arange(S, device=dev)
    cos, sin = rope_tables(cfg, torch.as_tensor(positions, device=dev))
    mask = None if attn_fn is not None else causal_mask(S, dev)
    fqs = fq if fq is not None else [None] * len(params["layers"])
    for lp, lfq in zip(params["layers"], fqs):
        x = llama_layer(cfg, fq_cfg, mode, lp, lfq, x, cos, sin, mask,
                        attn_fn=attn_fn)
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    return (x @ head.T.to(x.dtype)).to(torch.float32)


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
