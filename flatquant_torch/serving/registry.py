"""Serving model registry (port of flatquant_tpu/serving/registry.py, the
vllm_custom registry.py analog).

Maps architecture names to builders of packed serving params:

    build = get_serving_builder("LlamaFlatQuantForCausalLM")
    sp = build(cfg, fq_cfg, baked_params, baked_fq)

with JAX's five architectures: the learned FlatQuant transforms and the
untransformed fake-quantized baseline (an untrained FQ state) for the
Llama and Qwen2 families (one config-driven builder serves both), and
the QuaRot Hadamard baseline.
"""

from __future__ import annotations

from typing import Callable, Dict

from flatquant_torch.serving.quantized import (
    build_hadamard_serving_params,
    build_serving_params,
)

_REGISTRY: Dict[str, Callable] = {}


def register_arch(name: str, builder: Callable) -> None:
    _REGISTRY[name] = builder


def get_serving_builder(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown serving arch {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def _hadamard_builder(cfg, fq_cfg, params, _baked_fq=None, **kw):
    return build_hadamard_serving_params(cfg, fq_cfg, params, **kw)


for _arch in ("LlamaFlatQuantForCausalLM", "Qwen2FlatQuantForCausalLM",
              "LlamaFakeQuantizedForCausalLM",
              "Qwen2FakeQuantizedForCausalLM"):
    register_arch(_arch, build_serving_params)
register_arch("LlamaQuaRotForCausalLM", _hadamard_builder)
