"""The llama engine family: Llama / Qwen2 packed by the port's
`build_serving_layer` and served by `ContinuousBatcher` over its own
engine (serving/engine.py `_forward`).

`build` makes every layer from the seed (portbench/weights/llama.py),
folds the inverse transforms and the LWC clips into the weights with the
port's `transform_weight`, packs the layer, and frees the raw weights
before the next is made. `work` gives the model's work in one forward
call from the layer's shapes and the call's tokens, never from which
kernels ran.
"""

from __future__ import annotations

import dataclasses

import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize import spec
from flatquant_torch.quantize.linear import LinearQuantState, transform_weight
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.serving.quantized import build_serving_layer
from portbench.weights import llama as weights

# no span inside the program: the harness's wrappers of the batcher's
# calls cover this family
SPANS = ()


def port_config(cfg: dict) -> LlamaConfig:
    H, I, nh, nkv, hd, L, V = weights.dims(cfg)
    return LlamaConfig(name=cfg["name"], vocab_size=V, hidden_size=H,
                       intermediate_size=I, num_layers=L, num_heads=nh,
                       num_kv_heads=nkv, head_dim=hd,
                       rope_theta=float(cfg["rope_theta"]),
                       rms_eps=float(cfg["rms_norm_eps"]),
                       attn_bias=bool(cfg.get("qkv_bias", False)),
                       tie_embeddings=bool(cfg["tie_word_embeddings"]))


def fq_config(cfg: dict):
    fq = cfg["flatquant"]
    return dataclasses.replace(getattr(spec, fq["recipe"]),
                               tpu_decompose=fq["split"] == "rn128")


def _layer(cfg, pc, fq, seed, i, device, dtype):
    raw = weights.make_layer(cfg, seed, i, device)
    clip_raw = cfg["weights"]["clip_init"]

    def bake(w, left_right):
        """W P^{-T} over the in features, then LWC at its init."""
        full = torch.full((w.shape[0], 1), clip_raw, device=w.device)
        st = LinearQuantState(clip_w_max=full, clip_w_min=full,
                              clip_a_max=None, clip_a_min=None)
        return transform_weight(w, st, left_right, lwc=fq.lwc)

    inv = {k: (raw[k][0][1], raw[k][1][1])
           for k in ("ln_t", "ug_t", "down_t")}
    eye = torch.eye(pc.head_dim, device=device)
    lp = {"ln1_w": raw["ln1_w"], "ln2_w": raw["ln2_w"],
          "wo": bake(raw["wo"], (raw["o_t"][1], eye)),
          "wdown": bake(raw["wdown"], inv["down_t"])}
    for key, t in (("wq", "ln_t"), ("wk", "ln_t"), ("wv", "ln_t"),
                   ("wup", "ug_t"), ("wgate", "ug_t")):
        lp[key] = bake(raw[key], inv[t])
    for key in ("bq", "bk", "bv"):
        if key in raw:
            lp[key] = raw[key]
    c = torch.tensor(raw["clip"], device=device)
    lt = {key: (raw[key][0][0], raw[key][1][0])
          for key in ("ln_t", "ug_t", "down_t")}
    lt.update(o_t=raw["o_t"][0], k_t=raw["k_t"][0], k_t_inv=raw["k_t"][1],
              kc_clip=(c, c), vc_clip=(c, c),
              a_clip={nm: (c, c) for nm in ("qkv", "o", "upgate", "down")})
    return build_serving_layer(pc, fq, lp, lt, dtype=dtype,
                               merge_projections=True)


def build(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The packed model; `dtype` is the serving dtype of the transform
    matrices (the tests hold the plain path to the reference in
    float32)."""
    pc, fq = port_config(cfg), fq_config(cfg)
    layers = [_layer(cfg, pc, fq, seed, i, device, dtype)
              for i in range(pc.num_layers)]
    outer = weights.make_outer(cfg, seed, device)
    sp = {"embed": outer["embed"], "lm_head": outer["head"],
          "final_norm_w": outer["final_norm"], "layers": layers}
    return {"cfg": pc, "fq": fq, "sp": sp}


def batcher(model: dict, bat: dict, device) -> ContinuousBatcher:
    slots, max_len, bs = bat["slots"], bat["max_len"], bat["block_size"]
    # the pool holds every slot's worst case: admission never waits on it
    n_blocks = slots * (-(-max_len // bs)) + 1
    return ContinuousBatcher(
        model["cfg"], model["fq"], model["sp"], batch_slots=slots,
        max_len=max_len, use_kernel=device.type == "cuda",
        compute_dtype=torch.bfloat16, cache_mode=bat["cache_mode"],
        n_blocks=n_blocks, block_size=bs,
        prefill_bucket=bat["prefill_bucket"],
        prefill_chunk=bat["prefill_chunk"], device=device)


def work(cfg: dict, fwd: dict) -> list:
    """The model's work in one forward call, as (kind, operations, bytes,
    peak) items: "int4_gemm" (each W4A4 linear of each layer at the
    call's true rows), "paged_attn" (a decode or chunk call's attention
    over the paged int4 cache), "attention" (a prefill's attention over
    its own K and V), "head"."""
    from portbench.harness import work as W

    H, I, nh, nkv, hd, L, V = weights.dims(cfg)
    m = fwd["rows"]
    per_layer = [W.gemm(m, H, (nh + 2 * nkv) * hd), W.gemm(m, nh * hd, H),
                 W.gemm(m, H, 2 * I, out_cols=I), W.gemm(m, I, H)]
    items = per_layer * L
    keys = W.attended_keys(fwd)
    ops = 2 * nh * (hd + hd) * keys
    if fwd["phase"] == "prefill":
        # a whole prompt attends its own unquantized K and V (flash)
        items += [("attention", ops, 0, W.PEAK_BF16)] * L
    else:
        # the paged int4 cache: K and V codes (hd/2 bytes each) with their
        # float32 scale and zero, read once a call; q and out in bf16
        read = (sum(fwd["valid"]) if fwd["phase"] == "decode"
                else fwd["start"] + m)
        nbytes = read * nkv * (hd + 16) + m * nh * hd * 4
        items += [("paged_attn", ops, nbytes, W.PEAK_BF16)] * L
    items.append(("head", 2 * fwd["emitted"] * H * V, 0, W.PEAK_BF16))
    return items
