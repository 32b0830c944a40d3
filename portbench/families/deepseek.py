"""The DeepSeek hooks family: DeepSeek-V2 packed W4A4 by the port's
`build_ds_serving_layer` and served by `ContinuousBatcher` through the
engine hooks `ds_batch_forward` / `ds_init_batch_cache` (the latent
caches in bf16; moe_impl "auto": the capacity-gather MoE for prefill
chunks of 256+ tokens, the dense-masked one in decode).

`build` makes every layer from the seed (portbench/weights/deepseek.py)
and hands the port its transforms as baked state (BakedDecompose with the
diagonal scales) and its LWC / LAC clips at their init; the port folds
and packs, and the raw weights are freed before the next layer is made.
"""

from __future__ import annotations

import torch

from flatquant_torch.core.transforms import BakedDecompose
from flatquant_torch.models import deepseek as ds
from flatquant_torch.quantize import spec
from flatquant_torch.quantize.linear import LinearQuantState
from flatquant_torch.serving.batcher import ContinuousBatcher
from portbench.weights import deepseek as weights

# spans inside the program that the traced run wraps: (module, function,
# span name)
SPANS = ((ds, "_routed_experts", "routed_experts"),)


def port_config(cfg: dict) -> ds.DeepSeekConfig:
    d, rs = weights.dims(cfg), cfg["rope_scaling"]
    if rs.get("mscale") != rs.get("mscale_all_dim"):
        raise ValueError("the port scales the softmax by one yarn mscale; "
                         "this configuration's two differ")
    if cfg["topk_method"] != "greedy" or cfg["norm_topk_prob"]:
        raise ValueError("the port's V2 gate is greedy top-k, unnormalized")
    return ds.DeepSeekConfig(
        name=cfg["name"], vocab_size=d["V"], dim=d["H"], inter_dim=d["I"],
        moe_inter_dim=d["mi"], n_layers=d["L"], n_dense_layers=d["dense"],
        n_heads=d["nh"], n_routed_experts=d["E"],
        n_shared_experts=cfg["n_shared_experts"], n_activated_experts=d["K"],
        n_expert_groups=cfg["n_group"], n_limited_groups=cfg["topk_group"],
        score_func=cfg["scoring_func"],
        route_scale=float(cfg["routed_scaling_factor"]),
        q_lora_rank=cfg["q_lora_rank"] or 0, kv_lora_rank=d["lora"],
        qk_nope_head_dim=d["nope"], qk_rope_head_dim=d["rope"],
        v_head_dim=d["v"],
        original_seq_len=rs["original_max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rs["factor"]),
        beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
        mscale=float(rs["mscale_all_dim"]),
        max_seq_len=cfg["max_position_embeddings"],
        rms_eps=float(cfg["rms_norm_eps"]))


def _baked(t):
    (left, left_inv), (right, right_inv), diag = t
    return BakedDecompose(left=left, right=right, left_inv=left_inv,
                          right_inv=right_inv, diag_scale=diag)


def _state(clip_raw, out_shape, device):
    """LWC clips per output channel and the shared LAC clips, at init."""
    full = torch.full(out_shape + (1,), clip_raw, device=device)
    a = torch.full((1,), clip_raw, device=device)
    return LinearQuantState(clip_w_max=full, clip_w_min=full, clip_a_max=a,
                            clip_a_min=a)


def _layer_state(cfg, raw, device):
    d, c = weights.dims(cfg), cfg["weights"]["clip_init"]
    tr = {k: _baked(v) for k, v in raw["trans"].items()}
    nh = d["nh"]
    attn = {"qkv_trans": tr["qkv_trans"], "wqb_trans": None,
            "wo_trans": tr["wo_trans"],
            "wq_a_lin": _state(c, (nh * (d["nope"] + d["rope"]),), device),
            "wq_b_lin": None,
            "wkv_a_lin": _state(c, (d["lora"] + d["rope"],), device),
            "wo_lin": _state(c, (d["H"],), device)}
    if "w1_trans" in tr:
        E = d["E"]
        ffn = {"w1_trans": tr["w1_trans"], "w2_trans": tr["w2_trans"],
               "routed_w2_trans": tr["routed_w2_trans"],
               "s_w1_lin": _state(c, (d["si"],), device),
               "s_w2_lin": _state(c, (d["H"],), device),
               "s_w3_lin": _state(c, (d["si"],), device),
               "e_w1_lin": _state(c, (E, d["mi"]), device),
               "e_w2_lin": _state(c, (E, d["H"]), device),
               "e_w3_lin": _state(c, (E, d["mi"]), device)}
    else:
        ffn = {"up_gate_trans": tr["up_gate_trans"],
               "down_trans": tr["down_trans"],
               "w1_lin": _state(c, (d["I"],), device),
               "w2_lin": _state(c, (d["H"],), device),
               "w3_lin": _state(c, (d["I"],), device)}
    return {"attn": attn, "ffn": ffn}


def build(cfg: dict, seed: int, device) -> dict:
    pc = port_config(cfg)
    fq = getattr(spec, cfg["flatquant"]["recipe"])
    sp = {"dense_layers": [], "moe_layers": []}
    baked = ([], [])
    for i in range(pc.n_layers):
        raw = weights.make_layer(cfg, seed, i, device)
        lfq = _layer_state(cfg, raw, device)
        lp = {k: v for k, v in raw.items() if k not in ("trans", "clip")}
        moe = weights.is_moe(cfg, i)
        sp["moe_layers" if moe else "dense_layers"].append(
            ds.build_ds_serving_layer(pc, fq, lp, lfq))
        baked[int(moe)].append(lfq)
        del raw, lp
    outer = weights.make_outer(cfg, seed, device)
    sp.update(embed=outer["embed"], head=outer["head"],
              final_norm=outer["final_norm"])
    return {"cfg": pc, "fq": fq, "sp": {"params": sp, "fq": baked}}


def batcher(model: dict, bat: dict, device) -> ContinuousBatcher:
    return ContinuousBatcher(
        model["cfg"], model["fq"], model["sp"], batch_slots=bat["slots"],
        max_len=bat["max_len"], use_kernel=device.type == "cuda",
        compute_dtype=torch.bfloat16, cache_mode=bat["cache_mode"],
        prefill_bucket=bat["prefill_bucket"],
        prefill_chunk=bat["prefill_chunk"], forward_fn=ds.ds_batch_forward,
        init_cache_fn=ds.ds_init_batch_cache, device=device)


def work(cfg: dict, fwd: dict) -> list:
    """The model's work in one forward call, as (kind, operations, bytes,
    peak) items: "int4_gemm" (the W4A4 linears outside the routed
    experts: wq, wkv_a, wo, the dense FFN, the shared experts),
    "routed" (each token's routed experts), "gate", "mla" (wkv_b's
    projection of the new latents and the attention over the keys, in
    MLA's unabsorbed form), "head"."""
    from portbench.harness import work as W

    d = weights.dims(cfg)
    H, nh, m = d["H"], d["nh"], fwd["rows"]
    qk, v = d["nope"] + d["rope"], d["v"]
    attn = [W.gemm(m, H, nh * qk), W.gemm(m, H, d["lora"] + d["rope"]),
            W.gemm(m, nh * v, H)]
    keys = W.attended_keys(fwd)
    mla = ("mla", 2 * m * d["lora"] * nh * (d["nope"] + v)
           + 2 * nh * (qk + v) * keys, 0, W.PEAK_BF16)
    dense = [W.gemm(m, H, d["I"]), W.gemm(m, H, d["I"]),
             W.gemm(m, d["I"], H)]
    si, mi = d["si"], d["mi"]
    shared = [W.gemm(m, H, si), W.gemm(m, H, si), W.gemm(m, si, H)]
    routed = ("routed", 2 * m * d["K"] * 3 * H * mi, 0, W.PEAK_INT8)
    gate = ("gate", 2 * m * H * d["E"], 0, W.PEAK_BF16)
    items = []
    for i in range(d["L"]):
        items += attn + [mla]
        items += (shared + [routed, gate]) if weights.is_moe(cfg, i) \
            else dense
    items.append(("head", 2 * fwd["emitted"] * H * d["V"], 0, W.PEAK_BF16))
    return items
