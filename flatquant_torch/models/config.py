"""Model config registry (the port's own copy of flatquant_tpu/models/config.py).

One config-driven transformer covers Llama-2/3/3.1 and Qwen-2.5 (the
reference keeps four near-duplicate adapter files for these:
flatquant/model_tools/{llama,llama31,qwen}_utils.py — the structural deltas
are exactly the fields below: qkv bias, rope scaling, tied embeddings,
GQA head counts). The JAX package stays the reference; this copy keeps
the port free of any import from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 style rope scaling (HF rope_scaling type='llama3')."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    attn_bias: bool = False  # Qwen-2 has qkv bias
    tie_embeddings: bool = False
    rope_scaling: Optional[RopeScaling] = None
    seqlen: int = 2048  # calibration/eval sequence length (model_utils.py:24)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


_REGISTRY = {}


def register(cfg: LlamaConfig) -> LlamaConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> LlamaConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)


# --- Llama-2 ---------------------------------------------------------------
register(LlamaConfig(name="llama-2-7b"))
register(
    LlamaConfig(
        name="llama-2-13b",
        hidden_size=5120,
        intermediate_size=13824,
        num_layers=40,
        num_heads=40,
        num_kv_heads=40,
    )
)
register(
    LlamaConfig(
        name="llama-2-70b",
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
    )
)

# --- Llama-3 ---------------------------------------------------------------
register(
    LlamaConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=500000.0,
    )
)
register(
    LlamaConfig(
        name="llama-3-70b",
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        rope_theta=500000.0,
    )
)
register(
    LlamaConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=500000.0,
        rope_scaling=RopeScaling(),
    )
)

# --- Qwen-2.5 --------------------------------------------------------------
register(
    LlamaConfig(
        name="qwen-2.5-7b",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        attn_bias=True,
    )
)
register(
    LlamaConfig(
        name="qwen-2.5-32b",
        vocab_size=152064,
        hidden_size=5120,
        intermediate_size=27648,
        num_layers=64,
        num_heads=40,
        num_kv_heads=8,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        attn_bias=True,
    )
)
register(
    LlamaConfig(
        name="qwen-2.5-0.5b",
        vocab_size=151936,
        hidden_size=896,
        intermediate_size=4864,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        attn_bias=True,
        tie_embeddings=True,
    )
)

# --- tiny configs for tests / CI (random weights, CPU-runnable) ------------
register(
    LlamaConfig(
        name="tiny-llama",
        vocab_size=256,
        hidden_size=64,
        intermediate_size=176,  # (11, 16) kron factors
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        seqlen=64,
    )
)
register(
    LlamaConfig(
        name="tiny-qwen",
        vocab_size=256,
        hidden_size=48,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=12,
        attn_bias=True,
        tie_embeddings=True,
        seqlen=64,
    )
)
