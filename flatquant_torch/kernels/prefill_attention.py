"""Prefill attention (port of flatquant_tpu/kernels/prefill_attention.py).

Only the dense causal path is ported: it is plain tensor math, which the
JAX package also runs outside any Pallas kernel, and it is what prompts
shorter than 1024 tokens take. The flash kernels (Pallas
flash_prefill_attention / _kt) arrive with the long-prompt slices
(ROADMAP queue 2).
"""

from __future__ import annotations

import torch


def dense_causal_attention(q, k, v, sm_scale: float,
                           compute_dtype=torch.bfloat16):
    """q [B, S, nh, hd]; k/v [B, S, nkv, hd] -> [B, S, nh, hd] in
    compute_dtype. Scores in float32 with a -1e9 causal bias, probs cast
    back to compute_dtype before the PV product (as in JAX)."""
    S = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    bias = torch.where(causal, 0.0, -1e9)[None, None]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute_dtype),
                          k.to(compute_dtype))
    scores = scores.to(torch.float32) * sm_scale + bias
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(compute_dtype))
