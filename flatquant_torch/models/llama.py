"""Llama building blocks and random-weight init (port of the serving
subset of flatquant_tpu/models/llama.py).

Parameters are plain dicts of tensors; "layers" is a Python list with one
dict per layer (JAX stacks them on a leading axis for lax.scan). Weight
layout is [out_features, in_features]; matmuls are x @ W^T. The fp and
fake-quant forward arrive with the build chain (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig


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


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: [B, S, h, d]; cos/sin: [S, d] (broadcast over batch/heads)."""
    cos = cos[None, :, None, :].to(q.dtype)
    sin = sin[None, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
