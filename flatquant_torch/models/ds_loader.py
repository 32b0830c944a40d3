"""HF DeepSeek-V2/V3/R1 checkpoint loading: FP8 block-scaled safetensors
-> the port's DeepSeek params (port of flatquant_tpu/models/ds_loader.py).

The official HF distribution stores linear weights as float8_e4m3 with a
sibling `<name>.weight_scale_inv` [ceil(out/128), ceil(in/128)] float32
tile scale. The loader dequantizes them once (they proceed to int4
anyway), or with keep_fp8=True keeps the checkpoint's own codes for the
native-FP8 serving path (kernels/fp8_matmul.py, row 16). Key mapping (HF
name -> the port's per-layer key):

  model.embed_tokens.weight                    embed
  model.norm.weight / lm_head.weight           final_norm / head
  model.layers.N.input_layernorm.weight        attn_norm
  ...post_attention_layernorm.weight           ffn_norm
  ...self_attn.q_a_proj / q_a_layernorm /      wq_a / q_norm / wq_b
     q_b_proj      (or q_proj without q-LoRA -> wq)
  ...self_attn.kv_a_proj_with_mqa /            wkv_a / kv_norm / wkv_b /
     kv_a_layernorm / kv_b_proj / o_proj       wo
  ...mlp.gate_proj / up_proj / down_proj       w1 / w3 / w2   (dense)
  ...mlp.experts.E.{gate,up,down}_proj         e_w1 / e_w3 / e_w2 [E, ...]
  ...mlp.shared_experts.{gate,up,down}_proj    s_w1 / s_w3 / s_w2
  ...mlp.gate.weight / e_score_correction_bias gate_w / gate_b

The output is the port's layout ("dense_layers" / "moe_layers": lists of
per-layer dicts), the one init_ds_params, build_ds_fp8_serving_layer and
deepseek_generate take. Shards are read one tensor at a time
(native/safetensors_io.py), each moved to `device` and decoded there.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.fp8_matmul import BLOCK, expand_fp8_scales
from flatquant_torch.models.deepseek import DeepSeekConfig
from flatquant_torch.native import fp8_block_dequant
from flatquant_torch.native.safetensors_io import (
    SafetensorsFile,
    shard_files,
    write_safetensors,
)

_ATTN_MAP = {
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "ffn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.q_a_proj.weight": "wq_a",
    "self_attn.q_a_layernorm.weight": "q_norm",
    "self_attn.q_b_proj.weight": "wq_b",
    "self_attn.kv_a_proj_with_mqa.weight": "wkv_a",
    "self_attn.kv_a_layernorm.weight": "kv_norm",
    "self_attn.kv_b_proj.weight": "wkv_b",
    "self_attn.o_proj.weight": "wo",
}
_FFN_MAP = {
    "mlp.gate_proj.weight": "w1",
    "mlp.up_proj.weight": "w3",
    "mlp.down_proj.weight": "w2",
}
_SHARED_MAP = {
    "mlp.shared_experts.gate_proj.weight": "s_w1",
    "mlp.shared_experts.up_proj.weight": "s_w3",
    "mlp.shared_experts.down_proj.weight": "s_w2",
}
_EXPERT_MAP = {"gate_proj": "e_w1", "up_proj": "e_w3", "down_proj": "e_w2"}


def ds_config_from_hf_json(path: str, name: str = "deepseek-hf",
                           **overrides) -> DeepSeekConfig:
    """DeepSeekConfig from an HF config.json (DeepseekV3Config schema)."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    rs = c.get("rope_scaling") or {}
    kw = dict(
        name=name,
        vocab_size=c["vocab_size"],
        dim=c["hidden_size"],
        inter_dim=c["intermediate_size"],
        moe_inter_dim=c.get("moe_intermediate_size", c["intermediate_size"]),
        n_layers=c["num_hidden_layers"],
        n_dense_layers=c.get("first_k_dense_replace", 1),
        n_heads=c["num_attention_heads"],
        n_routed_experts=c.get("n_routed_experts", 64),
        n_shared_experts=c.get("n_shared_experts", 2),
        n_activated_experts=c.get("num_experts_per_tok", 6),
        n_expert_groups=c.get("n_group", 1),
        n_limited_groups=c.get("topk_group", 1),
        score_func=c.get("scoring_func", "softmax"),
        route_scale=c.get("routed_scaling_factor", 1.0),
        gate_bias=c.get("topk_method") == "noaux_tc",
        q_lora_rank=c.get("q_lora_rank") or 0,
        kv_lora_rank=c.get("kv_lora_rank", 512),
        qk_nope_head_dim=c.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=c.get("qk_rope_head_dim", 64),
        v_head_dim=c.get("v_head_dim", 128),
        rope_theta=c.get("rope_theta", 10000.0),
        rope_factor=rs.get("factor", 40.0),
        original_seq_len=rs.get("original_max_position_embeddings", 4096),
        beta_fast=int(rs.get("beta_fast", 32)),
        beta_slow=int(rs.get("beta_slow", 1)),
        mscale=rs.get("mscale", 1.0),
        max_seq_len=c.get("max_position_embeddings", 16384),
        rms_eps=c.get("rms_norm_eps", 1e-6),
    )
    kw.update(overrides)
    return DeepSeekConfig(**kw)


def _no_nan_codes(raw: torch.Tensor, name: str):
    if bool(((raw & 0x7F) == 0x7F).any()):
        raise ValueError(f"NaN fp8 codes in {name}")


def _iter_hf_tensors(path: str, keep_fp8: bool, device):
    """(name, tensor on `device`) over every shard, one tensor at a time:
    an fp8 weight with a `weight_scale_inv` sibling is dequantized with its
    tile scales (float32), or with keep_fp8 given as (raw uint8 codes,
    scales); every other tensor as float32 (integers as stored)."""
    files = shard_files(path)
    scales: Dict[str, torch.Tensor] = {}
    for f in files:
        with SafetensorsFile(f, device) as sf:
            for nm in sf.keys():
                if nm.endswith(".weight_scale_inv"):
                    scales[nm] = sf.tensor_f32(nm)
    for f in files:
        with SafetensorsFile(f, device) as sf:
            for nm in sf.keys():
                if nm.endswith(".weight_scale_inv"):
                    continue
                snm = nm + "_scale_inv"
                if snm not in scales:
                    yield nm, sf.tensor_f32(nm)
                elif keep_fp8:
                    raw, tag = sf.raw(nm)
                    if tag != "F8_E4M3":
                        raise ValueError(f"{nm} has scales but is {tag}")
                    yield nm, (raw, scales[snm])
                else:
                    yield nm, sf.fp8_tensor_dequant(nm, scales[snm])


def _fp8_linear_dict(raw: torch.Tensor, scales: torch.Tensor) -> dict:
    """The checkpoint's codes [(E,) N, K] and 128-tile scales as a serving
    dict {"w8", "se"} (kernels/fp8_matmul.py). A K that is neither a
    multiple of 128 nor within one block is refused, as JAX's
    expand_fp8_scales refuses it."""
    _no_nan_codes(raw, "the checkpoint")
    n, k = raw.shape[-2:]
    return {"w8": raw.view(torch.float8_e4m3fn),
            "se": expand_fp8_scales(scales, n, k)}


def _dequant(name, w):
    """A keep_fp8 (raw codes, scales) pair dequantized to float32."""
    raw, sc = w
    _no_nan_codes(raw, name)
    return fp8_block_dequant(raw, sc)


def load_hf_deepseek(path: str, cfg: DeepSeekConfig, dtype=torch.float32,
                     keep_fp8: bool = False, device="cuda") -> dict:
    """Load an HF DeepSeek checkpoint directory into the port's params on
    `device`, every tensor moved there as it is read.

    keep_fp8=True: every fp8-stored linear of a layer becomes a native-FP8
    serving dict {"w8" float8_e4m3fn, "se"} holding the checkpoint's own
    codes (the routed experts stacked [E, ...] per layer). wkv_b is the
    exception: the absorbed-MLA einsums consume it dense, so it
    dequantizes to `dtype`; so does any fp8 tensor outside the layers
    (embed / head / final norm). A linear whose K is neither a multiple
    of 128 nor within one block (DeepSeek-V2-Lite's dense down
    projection, K = 10944) is refused, as JAX's loader refuses it.
    Layers past cfg.n_layers (the V3/R1 multi-token-prediction block) are
    skipped."""
    dev = resolve_device(device)
    nd, nm_ = cfg.n_dense_layers, cfg.n_moe_layers
    dense = [dict() for _ in range(nd)]
    moe = [dict() for _ in range(nm_)]
    experts = [dict() for _ in range(nm_)]
    top: Dict[str, torch.Tensor] = {}

    def cast(w):
        return w if isinstance(w, tuple) else w.to(dtype)

    for name, w in _iter_hf_tensors(path, keep_fp8, dev):
        if isinstance(w, tuple) and (name.endswith("kv_b_proj.weight")
                                     or not name.startswith("model.layers.")):
            w = _dequant(name, w)
        if name == "model.embed_tokens.weight":
            top["embed"] = w.to(dtype)
        elif name == "model.norm.weight":
            top["final_norm"] = w.to(dtype)
        elif name == "lm_head.weight":
            top["head"] = w.to(dtype)
        elif name.startswith("model.layers."):
            idx_s, sub = name[len("model.layers."):].split(".", 1)
            li = int(idx_s)
            if li >= cfg.n_layers:
                continue
            is_dense = li < nd
            store = dense[li] if is_dense else moe[li - nd]
            if sub in _ATTN_MAP:
                store[_ATTN_MAP[sub]] = cast(w)
            elif is_dense and sub in _FFN_MAP:
                store[_FFN_MAP[sub]] = cast(w)
            elif sub in _SHARED_MAP:
                store[_SHARED_MAP[sub]] = cast(w)
            elif sub == "mlp.gate.weight":
                store["gate_w"] = cast(w)
            elif sub == "mlp.gate.e_score_correction_bias":
                store["gate_b"] = cast(w)
            elif sub.startswith("mlp.experts."):
                e_s, proj = sub[len("mlp.experts."):].split(".", 1)
                key = _EXPERT_MAP[proj.removesuffix(".weight")]
                experts[li - nd].setdefault(key, {})[int(e_s)] = cast(w)

    for i, (store, ex) in enumerate(zip(moe, experts)):
        for key, by_e in ex.items():
            missing = [e for e in range(cfg.n_routed_experts)
                       if e not in by_e]
            if missing:
                raise ValueError(f"missing moe {key} of layer {i} for "
                                 f"experts {missing}")
            vals = [by_e[e] for e in range(cfg.n_routed_experts)]
            store[key] = (torch.stack(vals) if not isinstance(vals[0], tuple)
                          else (torch.stack([v[0] for v in vals]),
                                torch.stack([v[1] for v in vals])))
    for label, layers in (("dense", dense), ("moe", moe)):
        keys = set().union(*layers) if layers else set()
        for i, store in enumerate(layers):
            if set(store) != keys:
                raise ValueError(f"missing {label} {sorted(keys - set(store))}"
                                 f" for layer {i}")
            for key, v in store.items():
                if isinstance(v, tuple):
                    store[key] = _fp8_linear_dict(*v)
    return {"embed": top["embed"], "final_norm": top["final_norm"],
            "head": top.get("head", top["embed"]),
            "dense_layers": dense, "moe_layers": moe}


def write_hf_deepseek_fixture(path: str, cfg: DeepSeekConfig, seed: int = 0,
                              fp8: bool = True, device="cuda") -> None:
    """Write a random checkpoint in the official HF layout (fp8 weights
    with 128-tile weight_scale_inv, or float32 with fp8=False) and its
    config.json: the loader's format proof for tests and offline runs.
    The numbers are drawn in JAX's order from a torch.Generator on
    `device` (on the CPU the file equals JAX's tensor for tensor) and
    copied to the host for the write."""
    os.makedirs(path, exist_ok=True)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def lin(name, out_d, in_d):
        w = randn(out_d, in_d) * 0.02
        if not fp8:
            sd[name + ".weight"] = w.cpu()
            return
        so, si = -(-out_d // BLOCK), -(-in_d // BLOCK)
        scale = torch.rand((so, si), generator=gen, device=dev) * 0.5 + 0.75
        sc = scale.repeat_interleave(BLOCK, 0)[:out_d].repeat_interleave(
            BLOCK, 1)[:, :in_d]
        sd[name + ".weight"] = (w / sc).to(torch.float8_e4m3fn).cpu()
        sd[name + ".weight_scale_inv"] = scale.cpu()

    def norm(name, d):
        sd[name + ".weight"] = torch.ones(d)

    sd["model.embed_tokens.weight"] = (randn(cfg.vocab_size, cfg.dim)
                                       * 0.02).cpu()
    norm("model.norm", cfg.dim)
    sd["lm_head.weight"] = (randn(cfg.vocab_size, cfg.dim) * 0.02).cpu()
    for li in range(cfg.n_layers):
        p = f"model.layers.{li}"
        norm(f"{p}.input_layernorm", cfg.dim)
        norm(f"{p}.post_attention_layernorm", cfg.dim)
        if cfg.q_lora_rank > 0:
            lin(f"{p}.self_attn.q_a_proj", cfg.q_lora_rank, cfg.dim)
            norm(f"{p}.self_attn.q_a_layernorm", cfg.q_lora_rank)
            lin(f"{p}.self_attn.q_b_proj", cfg.n_heads * cfg.qk_head_dim,
                cfg.q_lora_rank)
        else:
            lin(f"{p}.self_attn.q_proj", cfg.n_heads * cfg.qk_head_dim,
                cfg.dim)
        lin(f"{p}.self_attn.kv_a_proj_with_mqa",
            cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.dim)
        norm(f"{p}.self_attn.kv_a_layernorm", cfg.kv_lora_rank)
        lin(f"{p}.self_attn.kv_b_proj",
            cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            cfg.kv_lora_rank)
        lin(f"{p}.self_attn.o_proj", cfg.dim, cfg.n_heads * cfg.v_head_dim)
        if li < cfg.n_dense_layers:
            lin(f"{p}.mlp.gate_proj", cfg.inter_dim, cfg.dim)
            lin(f"{p}.mlp.up_proj", cfg.inter_dim, cfg.dim)
            lin(f"{p}.mlp.down_proj", cfg.dim, cfg.inter_dim)
            continue
        sd[f"{p}.mlp.gate.weight"] = (randn(cfg.n_routed_experts, cfg.dim)
                                      * 0.02).cpu()
        if cfg.gate_bias:
            sd[f"{p}.mlp.gate.e_score_correction_bias"] = torch.zeros(
                cfg.n_routed_experts)
        for e in range(cfg.n_routed_experts):
            lin(f"{p}.mlp.experts.{e}.gate_proj", cfg.moe_inter_dim, cfg.dim)
            lin(f"{p}.mlp.experts.{e}.up_proj", cfg.moe_inter_dim, cfg.dim)
            lin(f"{p}.mlp.experts.{e}.down_proj", cfg.dim, cfg.moe_inter_dim)
        si = cfg.n_shared_experts * cfg.moe_inter_dim
        lin(f"{p}.mlp.shared_experts.gate_proj", si, cfg.dim)
        lin(f"{p}.mlp.shared_experts.up_proj", si, cfg.dim)
        lin(f"{p}.mlp.shared_experts.down_proj", cfg.dim, si)
    write_safetensors(os.path.join(path, "model-00001-of-00001.safetensors"),
                      sd)
    hf_cfg = {
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "intermediate_size": cfg.inter_dim,
        "moe_intermediate_size": cfg.moe_inter_dim,
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.n_dense_layers,
        "num_attention_heads": cfg.n_heads,
        "n_routed_experts": cfg.n_routed_experts,
        "n_shared_experts": cfg.n_shared_experts,
        "num_experts_per_tok": cfg.n_activated_experts,
        "n_group": cfg.n_expert_groups, "topk_group": cfg.n_limited_groups,
        "scoring_func": cfg.score_func,
        "routed_scaling_factor": cfg.route_scale,
        "topk_method": "noaux_tc" if cfg.gate_bias else "greedy",
        "q_lora_rank": cfg.q_lora_rank or None,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": {
            "factor": cfg.rope_factor,
            "original_max_position_embeddings": cfg.original_seq_len,
            "beta_fast": cfg.beta_fast, "beta_slow": cfg.beta_slow,
            "mscale": cfg.mscale, "type": "yarn",
        },
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.rms_eps,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
