"""Seeded raw weights of a Llama-family model (Qwen2: qkv bias) under
FlatQuant W4A4KV4: per layer the bf16 linear weights [out, in] and biases
N(0, std^2), those that write the residual stream (wo, wdown) scaled by
out_scale, the two norm weights near 1, the Kronecker transforms of the
attention input ("ln_t"), the MLP input ("ug_t") and the down input
("down_t"), the o head mixing ("o_t") and the K-cache transform ("k_t"),
each as (P, P^{-T}); the LAC / LWC clip ratios at their init. Imports
torch only."""

from __future__ import annotations

import math

import torch

from portbench.weights.common import (
    bf16_normal,
    clip_ratio,
    factor,
    generator,
    kron_pair,
    near_one,
)


def dims(cfg: dict):
    """(H, I, heads, kv heads, head dim, layers, vocab)."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    return (H, cfg["intermediate_size"], nh, cfg["num_key_value_heads"],
            cfg.get("head_dim", H // nh), cfg["num_hidden_layers"],
            cfg["vocab_size"])


def make_layer(cfg: dict, seed: int, index: int, device) -> dict:
    H, I, nh, nkv, hd, _, _ = dims(cfg)
    w = cfg["weights"]
    gen = generator(seed, index, device)
    std, sig = w["init_std"], w["transform_sigma"]
    shapes = {"wq": (nh * hd, H), "wk": (nkv * hd, H), "wv": (nkv * hd, H),
              "wo": (H, nh * hd), "wup": (I, H), "wgate": (I, H),
              "wdown": (H, I)}
    flat = bf16_normal(gen, (sum(math.prod(s) for s in shapes.values()),),
                       std, device)
    lp, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        lp[key] = flat[at:at + n].view(shape)
        at += n
    for key in ("wo", "wdown"):
        lp[key] = (lp[key] * w["out_scale"]).to(torch.bfloat16).float()
    if cfg.get("qkv_bias", False):
        b = bf16_normal(gen, (nh * hd + 2 * nkv * hd,), std, device)
        lp["bq"], lp["bk"], lp["bv"] = torch.split(
            b, [nh * hd, nkv * hd, nkv * hd])
    lp["ln1_w"] = near_one(gen, H, w["norm_sigma"], device)
    lp["ln2_w"] = near_one(gen, H, w["norm_sigma"], device)
    lp["ln_t"] = kron_pair(gen, H, sig, device)
    lp["ug_t"] = kron_pair(gen, H, sig, device)
    lp["down_t"] = kron_pair(gen, I, sig, device)
    lp["o_t"] = factor(gen, nh, sig, device)
    lp["k_t"] = factor(gen, hd, sig, device)
    lp["clip"] = clip_ratio(w["clip_init"])
    return lp


def make_outer(cfg: dict, seed: int, device) -> dict:
    """The embedding and the head (bf16) and the final norm weight."""
    H, _, _, _, _, L, V = dims(cfg)
    w = cfg["weights"]
    gen = generator(seed, L, device)
    std = w["init_std"]
    emb = (torch.randn((V, H), generator=gen, device=device,
                       dtype=torch.bfloat16) * w["embed_std"])
    head = (torch.randn((V, H), generator=gen, device=device,
                        dtype=torch.bfloat16) * std)
    return {"embed": emb, "head": head,
            "final_norm": near_one(gen, H, w["norm_sigma"], device)}
