"""Seeded raw weights of a DeepSeek-V2 model (MLA without a q LoRA,
shared and routed experts) under FlatQuant W4A4: per layer the bf16
linear weights [out, in] (routed experts stacked [E, out, in]) N(0,
std^2), those that write the residual stream (wo, w2, s_w2, e_w2) scaled
by out_scale, the gate [E, H] in float32, the embedding N(0,
embed_std^2), the norm weights near 1, and the
Kronecker transforms with their diagonal scales: "qkv_trans" (attention
input), "wo_trans" (o input), and "up_gate_trans" / "down_trans" (dense
FFN) or "w1_trans" (MoE input, shared by every expert), "w2_trans" (the
shared experts' down input), "routed_w2_trans" (the routed experts' down
input), each as ((L, L^{-T}), (R, R^{-T}), diag). The LAC / LWC clip
ratios sit at their init. Imports torch only."""

from __future__ import annotations

import math

import torch

from portbench.weights.common import (
    bf16_normal,
    clip_ratio,
    generator,
    kron_pair,
    near_one,
)


def dims(cfg: dict) -> dict:
    nh = cfg["num_attention_heads"]
    return {
        "H": cfg["hidden_size"], "I": cfg["intermediate_size"],
        "mi": cfg["moe_intermediate_size"], "nh": nh,
        "E": cfg["n_routed_experts"], "K": cfg["num_experts_per_tok"],
        "si": cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
        "lora": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
        "rope": cfg["qk_rope_head_dim"], "v": cfg["v_head_dim"],
        "L": cfg["num_hidden_layers"], "dense": cfg["first_k_dense_replace"],
        "V": cfg["vocab_size"],
    }


def is_moe(cfg: dict, index: int) -> bool:
    return index >= cfg["first_k_dense_replace"]


def _transform(gen, n, w, device):
    left, right = kron_pair(gen, n, w["transform_sigma"], device)
    diag = torch.exp(w["diag_sigma"] * torch.randn(
        (n,), generator=gen, device=device, dtype=torch.float32))
    return left, right, diag


def make_layer(cfg: dict, seed: int, index: int, device) -> dict:
    d, w = dims(cfg), cfg["weights"]
    H, nh = d["H"], d["nh"]
    qk = d["nope"] + d["rope"]
    gen = generator(seed, index, device)
    shapes = {"wq": (nh * qk, H), "wkv_a": (d["lora"] + d["rope"], H),
              "wkv_b": (nh * (d["nope"] + d["v"]), d["lora"]),
              "wo": (H, nh * d["v"])}
    moe = is_moe(cfg, index)
    if moe:
        E, mi, si = d["E"], d["mi"], d["si"]
        shapes.update(e_w1=(E, mi, H), e_w2=(E, H, mi), e_w3=(E, mi, H),
                      s_w1=(si, H), s_w2=(H, si), s_w3=(si, H))
    else:
        shapes.update(w1=(d["I"], H), w2=(H, d["I"]), w3=(d["I"], H))
    flat = bf16_normal(gen, (sum(math.prod(s) for s in shapes.values()),),
                       w["init_std"], device)
    lp, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        lp[key] = flat[at:at + n].view(shape)
        at += n
    for key in ("wo", "w2", "s_w2", "e_w2"):
        if key in lp:
            lp[key] = (lp[key] * w["out_scale"]).to(torch.bfloat16).float()
    if moe:
        lp["gate_w"] = bf16_normal(gen, (d["E"], H), w["init_std"], device)
    for key, n in (("attn_norm", H), ("ffn_norm", H),
                   ("kv_norm", d["lora"])):
        lp[key] = near_one(gen, n, w["norm_sigma"], device)
    tr = {"qkv_trans": _transform(gen, H, w, device),
          "wo_trans": _transform(gen, nh * d["v"], w, device)}
    if moe:
        tr.update(w1_trans=_transform(gen, H, w, device),
                  w2_trans=_transform(gen, d["si"], w, device),
                  routed_w2_trans=_transform(gen, d["mi"], w, device))
    else:
        tr.update(up_gate_trans=_transform(gen, H, w, device),
                  down_trans=_transform(gen, d["I"], w, device))
    lp["trans"] = tr
    lp["clip"] = clip_ratio(w["clip_init"])
    return lp


def make_outer(cfg: dict, seed: int, device) -> dict:
    """The embedding and the head (bf16) and the final norm weight."""
    d, w = dims(cfg), cfg["weights"]
    gen = generator(seed, d["L"], device)
    shape = (d["V"], d["H"])
    emb = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.bfloat16) * w["embed_std"]
    head = torch.randn(shape, generator=gen, device=device,
                       dtype=torch.bfloat16) * w["init_std"]
    return {"embed": emb, "head": head,
            "final_norm": near_one(gen, d["H"], w["norm_sigma"], device)}
