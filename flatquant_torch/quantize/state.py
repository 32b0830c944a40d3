"""Per-layer FlatQuant state: transforms and clip factors (port of
flatquant_tpu/quantize/state.py).

The model forward takes (params, fq_state, mode) and threads the
transforms into each linear. The state is a Python list with one
LayerFQ per layer (JAX stacks the leaves on a leading [L] axis for
lax.scan). Creation conditions mirror the reference's add_fq_trans
(llama_utils.py:141-162) and cache quantizers (llama_utils.py:123-131).

`init_model_fq` draws every factor on the host from one
np.random.default_rng(seed) in JAX's order (per layer: ln, o, up_gate,
down, kcache, vcache; left then right within a pair; u then v within an
SVD factor), so the same seed gives JAX's float32 state bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from flatquant_torch.core.transforms import (
    AnyDecompose,
    AnySingle,
    bake_decompose,
    bake_single,
    init_decompose,
    init_single,
)
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.linear import (
    CLIP_INIT,
    LinearQuantState,
    init_linear_state,
)
from flatquant_torch.quantize.spec import FQConfig


@dataclasses.dataclass
class CacheQuantState:
    """LAC clip factors of a KV / Q cache quantizer (None = no LAC)."""

    clip_a_max: Optional[torch.Tensor]
    clip_a_min: Optional[torch.Tensor]


def _init_cache_state(lac: bool, device) -> CacheQuantState:
    def full():
        return torch.full((1,), CLIP_INIT, dtype=torch.float32,
                          device=device)

    return CacheQuantState(clip_a_max=full() if lac else None,
                           clip_a_min=full() if lac else None)


@dataclasses.dataclass
class AttnFQ:
    ln_trans: Optional[AnyDecompose]
    o_trans: Optional[AnySingle]  # acts on num_heads
    kcache_trans: Optional[AnySingle]  # acts on head_dim, post-RoPE
    vcache_trans: Optional[AnySingle]  # acts on head_dim, fused into v_proj
    q_lin: LinearQuantState
    k_lin: LinearQuantState
    v_lin: LinearQuantState
    o_lin: LinearQuantState
    q_cache: CacheQuantState
    k_cache: CacheQuantState
    v_cache: CacheQuantState


@dataclasses.dataclass
class MlpFQ:
    up_gate_trans: Optional[AnyDecompose]
    down_trans: Optional[AnyDecompose]
    up_lin: LinearQuantState
    gate_lin: LinearQuantState
    down_lin: LinearQuantState


@dataclasses.dataclass
class LayerFQ:
    attn: AttnFQ
    mlp: MlpFQ


def init_layer_fq(cfg: LlamaConfig, fq: FQConfig, rng: np.random.Generator,
                  tp: int = 1, device="cuda") -> LayerFQ:
    """One layer's state, its factors drawn from `rng`. tp > 1 builds
    shard-aligned transforms: the ones on row-parallel dims (o_trans on
    heads, down_trans on the intermediate) at size dim // tp, which the
    transforms' reshape then applies block-diagonally, one identical
    block per tensor-parallel shard, with no collective (JAX
    quantize/state.py:79-140)."""
    if cfg.intermediate_size % tp or cfg.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads "
                         f"{cfg.num_heads} and intermediate_size "
                         f"{cfg.intermediate_size}")
    dev = resolve_device(device)
    wa_quant = fq.w_bits < 16 or fq.a_bits < 16
    ln_trans = o_trans = kcache = vcache = None
    up_gate = down = None
    kw = dict(add_diag=fq.add_diag, direct_inv=fq.direct_inv,
              rn128=fq.tpu_decompose, device=dev)
    if wa_quant:
        ln_trans = init_decompose(cfg.hidden_size, rng, **kw)
        o_trans = init_single(cfg.num_heads // tp, rng, fq.direct_inv, dev)
        up_gate = init_decompose(cfg.hidden_size, rng, **kw)
        down = init_decompose(cfg.intermediate_size // tp, rng, **kw)
    if fq.k_bits < 16 or fq.q_bits < 16:
        kcache = init_single(cfg.head_dim, rng, fq.direct_inv, dev)
    if fq.v_bits < 16 or wa_quant:
        vcache = init_single(cfg.head_dim, rng, fq.direct_inv, dev)

    def lin(out):
        return init_linear_state(out, fq.lwc, fq.lac, dev)

    attn = AttnFQ(
        ln_trans=ln_trans, o_trans=o_trans, kcache_trans=kcache,
        vcache_trans=vcache, q_lin=lin(cfg.q_dim), k_lin=lin(cfg.kv_dim),
        v_lin=lin(cfg.kv_dim), o_lin=lin(cfg.hidden_size),
        q_cache=_init_cache_state(fq.lac and fq.q_bits < 16, dev),
        k_cache=_init_cache_state(fq.lac and fq.k_bits < 16, dev),
        v_cache=_init_cache_state(fq.lac and fq.v_bits < 16, dev))
    mlp = MlpFQ(up_gate_trans=up_gate, down_trans=down,
                up_lin=lin(cfg.intermediate_size),
                gate_lin=lin(cfg.intermediate_size),
                down_lin=lin(cfg.hidden_size))
    return LayerFQ(attn=attn, mlp=mlp)


def init_model_fq(cfg: LlamaConfig, fq: FQConfig, seed: int = 0,
                  tp: int = 1, device="cuda") -> List[LayerFQ]:
    """Every layer's state from one np.random.default_rng(seed), layer 0
    first: JAX's draws, as a list of LayerFQ (tp > 1: shard-aligned, see
    init_layer_fq)."""
    rng = np.random.default_rng(seed)
    return [init_layer_fq(cfg, fq, rng, tp=tp, device=device)
            for _ in range(cfg.num_layers)]


def bake_layer_fq(layer_fq: LayerFQ) -> LayerFQ:
    """Freeze every transform into fixed matrices (to_eval_mode analog)."""
    def mb(t, f):
        return None if t is None else f(t)

    a, m = layer_fq.attn, layer_fq.mlp
    attn = dataclasses.replace(
        a, ln_trans=mb(a.ln_trans, bake_decompose),
        o_trans=mb(a.o_trans, bake_single),
        kcache_trans=mb(a.kcache_trans, bake_single),
        vcache_trans=mb(a.vcache_trans, bake_single))
    mlp = dataclasses.replace(
        m, up_gate_trans=mb(m.up_gate_trans, bake_decompose),
        down_trans=mb(m.down_trans, bake_decompose))
    return LayerFQ(attn=attn, mlp=mlp)
