"""HF checkpoint loading: safetensors -> the port's params (port of
flatquant_tpu/models/loader.py).

Maps HF Llama/Qwen2 weight names (model.layers.N.self_attn.q_proj.weight,
...) onto the port's per-layer dicts of [out, in] tensors. Works from a
local directory of *.safetensors, read through the port's own reader
(utils/safetensors_io.py); no network access is attempted.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig, RopeScaling
from flatquant_torch.utils.safetensors_io import (
    read_safetensors,
    write_safetensors,
)


_LAYER_MAP = {
    "input_layernorm.weight": ("ln1_w", None),
    "post_attention_layernorm.weight": ("ln2_w", None),
    "self_attn.q_proj.weight": ("wq", None),
    "self_attn.k_proj.weight": ("wk", None),
    "self_attn.v_proj.weight": ("wv", None),
    "self_attn.o_proj.weight": ("wo", None),
    "self_attn.q_proj.bias": ("bq", None),
    "self_attn.k_proj.bias": ("bk", None),
    "self_attn.v_proj.bias": ("bv", None),
    "mlp.gate_proj.weight": ("wgate", None),
    "mlp.up_proj.weight": ("wup", None),
    "mlp.down_proj.weight": ("wdown", None),
}


def _iter_safetensors(path: str):
    """(name, tensor) over every *.safetensors file under `path`, floats
    widened to float32 (real HF Llama/Qwen shards are BF16)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for f in files:
        tensors, _ = read_safetensors(f)
        for name, t in tensors.items():
            yield name, t.to(torch.float32) if t.is_floating_point() else t


def params_from_named_tensors(items, cfg: LlamaConfig, dtype=torch.float32,
                              device="cuda") -> dict:
    """(name, tensor or array) pairs with HF Llama/Qwen key names -> the
    port's params {"embed", "final_norm_w"[, "lm_head"], "layers": [per-
    layer dict]} in `dtype` on `device`. Shared by the safetensors loader
    and the torch-state-dict converter (utils/reference_convert.py)."""
    dev = resolve_device(device)
    L = cfg.num_layers
    layers = [{} for _ in range(L)]
    top: Dict[str, torch.Tensor] = {}

    def put(t):
        return torch.as_tensor(t).to(device=dev, dtype=dtype)

    for name, tensor in items:
        if name == "model.embed_tokens.weight":
            top["embed"] = tensor
        elif name == "model.norm.weight":
            top["final_norm_w"] = tensor
        elif name == "lm_head.weight":
            top["lm_head"] = tensor
        elif name.startswith("model.layers."):
            idx_str, sub = name[len("model.layers."):].split(".", 1)
            if sub in _LAYER_MAP:
                layers[int(idx_str)][_LAYER_MAP[sub][0]] = put(tensor)

    keys = [k for k, _ in _LAYER_MAP.values()
            if any(k in lp for lp in layers)]
    for key in keys:
        missing = [i for i, lp in enumerate(layers) if key not in lp]
        if missing:
            raise ValueError(f"missing {key} for layers {missing}")
    params = {"embed": put(top["embed"]),
              "final_norm_w": put(top["final_norm_w"]),
              "layers": [{k: lp[k] for k in keys} for lp in layers]}
    if "lm_head" in top:
        params["lm_head"] = put(top["lm_head"])
    elif not cfg.tie_embeddings:
        raise ValueError("checkpoint has no lm_head but config is untied")
    return params


def load_hf_llama(path: str, cfg: LlamaConfig, dtype=torch.float32,
                  device="cuda") -> dict:
    """Load an HF Llama/Qwen2 checkpoint directory into the port's params."""
    return params_from_named_tensors(_iter_safetensors(path), cfg, dtype,
                                     device)


def write_hf_llama_fixture(path: str, cfg: LlamaConfig, seed: int = 0) -> None:
    """Write a small random checkpoint in the official HF Llama/Qwen2
    layout (BF16 tensors at the HF names + config.json): the loader-format
    proof for tests and offline hosts. The draws are JAX's
    write_hf_llama_fixture's (a CPU torch.Generator seeded the same, in
    the same order), so both packages write the same tensors.

    Reference analog: model_utils.get_model loading HF checkpoints
    (flatquant/model_utils.py:76)."""
    os.makedirs(path, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(name, out_d, in_d, bias=False):
        sd[name + ".weight"] = (
            torch.randn(out_d, in_d, generator=gen) * 0.05
        ).to(torch.bfloat16)
        if bias:
            sd[name + ".bias"] = (
                torch.randn(out_d, generator=gen) * 0.01
            ).to(torch.bfloat16)

    H, I = cfg.hidden_size, cfg.intermediate_size
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    sd["model.embed_tokens.weight"] = (
        torch.randn(cfg.vocab_size, H, generator=gen) * 0.05
    ).to(torch.bfloat16)
    sd["model.norm.weight"] = torch.ones(H, dtype=torch.bfloat16)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = (
            torch.randn(cfg.vocab_size, H, generator=gen) * 0.05
        ).to(torch.bfloat16)
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}"
        sd[f"{p}.input_layernorm.weight"] = torch.ones(H, dtype=torch.bfloat16)
        sd[f"{p}.post_attention_layernorm.weight"] = torch.ones(
            H, dtype=torch.bfloat16)
        lin(f"{p}.self_attn.q_proj", qd, H, bias=cfg.attn_bias)
        lin(f"{p}.self_attn.k_proj", kvd, H, bias=cfg.attn_bias)
        lin(f"{p}.self_attn.v_proj", kvd, H, bias=cfg.attn_bias)
        lin(f"{p}.self_attn.o_proj", H, qd)
        lin(f"{p}.mlp.gate_proj", I, H)
        lin(f"{p}.mlp.up_proj", I, H)
        lin(f"{p}.mlp.down_proj", H, I)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)

    conf = {
        "architectures": ["Qwen2ForCausalLM" if cfg.attn_bias
                          else "LlamaForCausalLM"],
        "model_type": "qwen2" if cfg.attn_bias else "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": H,
        "intermediate_size": I,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "attention_bias": cfg.attn_bias,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "bfloat16",
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f, indent=1)


def config_from_hf_json(path: str, name: str = "custom") -> LlamaConfig:
    """Build a LlamaConfig from an HF config.json (local file)."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    rs = None
    rc = c.get("rope_scaling")
    if rc and rc.get("rope_type", rc.get("type")) == "llama3":
        rs = RopeScaling(
            factor=rc["factor"],
            low_freq_factor=rc["low_freq_factor"],
            high_freq_factor=rc["high_freq_factor"],
            original_max_position_embeddings=rc["original_max_position_embeddings"],
        )
    num_heads = c["num_attention_heads"]
    return LlamaConfig(
        name=name,
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=c.get("num_key_value_heads", num_heads),
        head_dim=c.get("head_dim", c["hidden_size"] // num_heads),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_eps=c.get("rms_norm_eps", 1e-5),
        attn_bias=c.get("attention_bias", c.get("model_type") == "qwen2"),
        tie_embeddings=c.get("tie_word_embeddings", False),
        rope_scaling=rs,
    )
