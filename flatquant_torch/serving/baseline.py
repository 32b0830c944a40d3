"""bf16 baseline serving engine (port of flatquant_tpu/serving/baseline.py):
the comparator of the reference's FP16 benchmarks, the denominator of
every speedup the JAX package reports.

Same control flow as serving/engine.py with plain bf16 weights: no
transforms, no quantization. The linears are plain bf16 `torch.matmul`
(JAX leaves them to XLA); prefill attends through the port's
`prefill_attention` (the flash kernel for long prompts on a card, as the
JAX baseline takes its Pallas kernel on a TPU: on the CPU both packages
take the blockwise oracle); decode is the plain einsum over the bf16
cache of `engine.init_cache(mode="bf16")` (engine `_cache_attention`),
updated IN PLACE.
"""

from __future__ import annotations

import numpy as np
import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.prefill_attention import prefill_attention
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import (
    apply_rope,
    rms_norm,
    rope_tables,
    silu,
)
from flatquant_torch.serving.engine import _cache_attention


def build_bf16_params(cfg: LlamaConfig, params: dict) -> dict:
    """fp params {"embed", "final_norm_w"[, "lm_head"], "layers": [dict]}
    -> bf16 weights (final norm in float32; a tied model's head is its
    embedding)."""
    head = params.get("lm_head", params["embed"])
    return {
        "embed": params["embed"].to(torch.bfloat16),
        "final_norm_w": params["final_norm_w"].to(torch.float32),
        "lm_head": head.to(torch.bfloat16),
        "layers": [{k: v.to(torch.bfloat16) for k, v in lp.items()}
                   for lp in params["layers"]],
    }


def _lin(h, w, b=None):
    y = h @ w.T.to(h.dtype)
    return y + b.to(y.dtype) if b is not None else y


def _layer(cfg, lp, x, cos, sin, ck, cv, pos, phase):
    """One bf16 decoder layer; ck/cv [B, Smax, nkv, hd] written IN PLACE at
    [pos, pos + S). Returns the layer output."""
    B, S, H = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln1_w"], cfg.rms_eps)
    q = _lin(h, lp["wq"], lp.get("bq")).reshape(B, S, nh, hd)
    k = _lin(h, lp["wk"], lp.get("bk")).reshape(B, S, nkv, hd)
    v = _lin(h, lp["wv"], lp.get("bv")).reshape(B, S, nkv, hd)
    q, k = apply_rope(q, k, cos[pos:pos + S], sin[pos:pos + S])
    ck[:, pos:pos + S] = k.to(ck.dtype)
    cv[:, pos:pos + S] = v.to(cv.dtype)

    if phase == "prefill":
        # the same flash routing as the quantized engine: the baseline is
        # not handicapped with O(S^2) attention
        attn = prefill_attention(q, k, v, 1.0 / float(np.sqrt(hd)),
                                 q.is_cuda, q.dtype)
    else:
        attn = _cache_attention(q, ck, cv, pos, q.dtype)
    x = x + _lin(attn.reshape(B, S, nh * hd), lp["wo"])

    h2 = rms_norm(x, lp["ln2_w"], cfg.rms_eps)
    up = _lin(h2, lp["wup"])
    gate = _lin(h2, lp["wgate"])
    return x + _lin(silu(gate) * up, lp["wdown"])


def _forward(cfg, bp, tokens, cache, pos, phase, max_len):
    x = bp["embed"][tokens].to(torch.bfloat16)
    cos, sin = rope_tables(cfg, torch.arange(max_len, device=x.device))
    for i, lp in enumerate(bp["layers"]):
        x = _layer(cfg, lp, x, cos, sin, cache["k"][i], cache["v"][i], pos,
                   phase)
    x = rms_norm(x, bp["final_norm_w"], cfg.rms_eps)
    return (x[:, -1] @ bp["lm_head"].T.to(x.dtype)).to(torch.float32)


def _as_tokens(tokens, dev):
    return torch.as_tensor(tokens, device=dev).to(torch.long)


@torch.no_grad()
def bf16_prefill(cfg, bp, tokens, cache, max_len=2048, device="cuda"):
    """Prompt tokens [B, S] -> (last-token logits [B, V] float32, cache);
    cache from engine.init_cache(mode="bf16"), written in place."""
    dev = resolve_device(device)
    return _forward(cfg, bp, _as_tokens(tokens, dev), cache, 0, "prefill",
                    max_len), cache


@torch.no_grad()
def bf16_decode_step(cfg, bp, token, cache, pos, max_len=2048,
                     device="cuda"):
    """One decode step: token [B, 1] at position pos (an int) -> (logits
    [B, V] float32, cache), the cache updated in place."""
    dev = resolve_device(device)
    return _forward(cfg, bp, _as_tokens(token, dev), cache, int(pos),
                    "decode", max_len), cache
