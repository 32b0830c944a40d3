"""Interop with reference (PyTorch FlatQuant) artifacts (port of
flatquant_tpu/utils/reference_convert.py:60-217; the deploy-packed half,
:219-388, is not ported yet: ROADMAP queue 1 item 5).

The reference releases `flat_matrices.pth` checkpoints — per-layer dicts
of eval-mode transform matrices and clip factors saved by
`save_flat_matrices` (flat_utils.py:65-93, key filter ["trans.matrix",
"trans.diag_scale", "clip_factor_w", "clip_factor_a"]). This module
converts

  - a torch HF Llama/Qwen state dict            -> the port's fp params
  - a reference `flat_matrices.pth` object      -> the port's list of
    LayerFQ of baked transforms and clip factors, ready for
    `quantize.bake.bake_model` (the --reload_matrix flow: load matrices,
    bake fresh fp weights against them, eval / export)

and gives the pre-fold "matrices" form of the port's own FQ state
(`rep_matrix_only` analog) that --save_matrix writes: saved BEFORE the
bake, reloaded onto raw weights, baked again.

Reference key schema per layer (direct_inv or SVD, after to_eval_mode —
trans_utils.py:39-46 / 105-116 / 153-159 / 206-213):

  self_attn.ln_trans.matrix_left / matrix_right / matrix_left_inv /
      matrix_right_inv / diag_scale
  self_attn.{o,kcache,vcache}_trans.matrix / matrix_inv_t
  mlp.{up_gate,down}_trans.matrix_* / diag_scale
  {self_attn.{q,k,v,o}_proj, mlp.{up,gate,down}_proj}.clip_factor_w_{max,min}
  {...}_proj.act_quantizer.clip_factor_a_{max,min}
  self_attn.{q,k,v}_cache_quantizer.clip_factor_a_{max,min}

`matrix_left_inv` / `matrix_inv_t` hold the inverse-TRANSPOSE of the
factor (trans_utils.py:42,109-110,156,210-211) — the convention of
BakedSingle.matrix_inv_t / BakedDecompose.left_inv.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from flatquant_torch.core.transforms import BakedDecompose, BakedSingle
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.loader import params_from_named_tensors
from flatquant_torch.quantize.linear import LinearQuantState
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import (
    AttnFQ,
    CacheQuantState,
    LayerFQ,
    MlpFQ,
    bake_layer_fq,
    init_model_fq,
)


def _f32(t, dev) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(device=dev, dtype=torch.float32)


# ---------------------------------------------------------------------------
# torch HF state dict -> the port's params
# ---------------------------------------------------------------------------


def params_from_torch_state_dict(sd: Dict[str, object], cfg: LlamaConfig,
                                 dtype=torch.float32, device="cuda") -> dict:
    """HF Llama/Qwen2 `model.state_dict()` -> the port's params."""
    return params_from_named_tensors(sd.items(), cfg, dtype, device)


# ---------------------------------------------------------------------------
# reference flat_matrices -> the port's baked FQ state
# ---------------------------------------------------------------------------


def _get(d, key, dev):
    return _f32(d[key], dev) if key in d else None


def _decompose_from(d, prefix: str, dev) -> Optional[BakedDecompose]:
    if f"{prefix}.matrix_left" not in d:
        return None
    return BakedDecompose(
        left=_f32(d[f"{prefix}.matrix_left"], dev),
        right=_f32(d[f"{prefix}.matrix_right"], dev),
        left_inv=_f32(d[f"{prefix}.matrix_left_inv"], dev),
        right_inv=_f32(d[f"{prefix}.matrix_right_inv"], dev),
        diag_scale=_get(d, f"{prefix}.diag_scale", dev))


def _single_from(d, prefix: str, dev) -> Optional[BakedSingle]:
    if f"{prefix}.matrix" not in d:
        return None
    return BakedSingle(matrix=_f32(d[f"{prefix}.matrix"], dev),
                       matrix_inv_t=_f32(d[f"{prefix}.matrix_inv_t"], dev))


def _linear_from(d, prefix: str, dev) -> LinearQuantState:
    return LinearQuantState(
        clip_w_max=_get(d, f"{prefix}.clip_factor_w_max", dev),
        clip_w_min=_get(d, f"{prefix}.clip_factor_w_min", dev),
        clip_a_max=_get(d, f"{prefix}.act_quantizer.clip_factor_a_max", dev),
        clip_a_min=_get(d, f"{prefix}.act_quantizer.clip_factor_a_min", dev))


def _cache_from(d, prefix: str, dev) -> CacheQuantState:
    return CacheQuantState(
        clip_a_max=_get(d, f"{prefix}.clip_factor_a_max", dev),
        clip_a_min=_get(d, f"{prefix}.clip_factor_a_min", dev))


def layer_fq_from_reference_dict(d: Dict[str, object],
                                 device="cuda") -> LayerFQ:
    """One layer's flat_matrices entry -> LayerFQ of baked transforms."""
    dev = resolve_device(device)
    sa, mlp = "self_attn.", "mlp."
    attn = AttnFQ(
        ln_trans=_decompose_from(d, sa + "ln_trans", dev),
        o_trans=_single_from(d, sa + "o_trans", dev),
        kcache_trans=_single_from(d, sa + "kcache_trans", dev),
        vcache_trans=_single_from(d, sa + "vcache_trans", dev),
        q_lin=_linear_from(d, sa + "q_proj", dev),
        k_lin=_linear_from(d, sa + "k_proj", dev),
        v_lin=_linear_from(d, sa + "v_proj", dev),
        o_lin=_linear_from(d, sa + "o_proj", dev),
        q_cache=_cache_from(d, sa + "q_cache_quantizer", dev),
        k_cache=_cache_from(d, sa + "k_cache_quantizer", dev),
        v_cache=_cache_from(d, sa + "v_cache_quantizer", dev))
    return LayerFQ(attn=attn, mlp=MlpFQ(
        up_gate_trans=_decompose_from(d, mlp + "up_gate_trans", dev),
        down_trans=_decompose_from(d, mlp + "down_trans", dev),
        up_lin=_linear_from(d, mlp + "up_proj", dev),
        gate_lin=_linear_from(d, mlp + "gate_proj", dev),
        down_lin=_linear_from(d, mlp + "down_proj", dev)))


def fq_from_flat_matrices(matrices: Dict[int, Dict[str, object]],
                          cfg: LlamaConfig, device="cuda") -> List[LayerFQ]:
    """Reference flat_matrices object ({layer: {key: tensor}}) -> the
    port's list of LayerFQ, ready for `bake_model`."""
    return [layer_fq_from_reference_dict(matrices[i], device)
            for i in range(cfg.num_layers)]


def load_reference_flat_matrices(path: str):
    """torch.load a reference flat_matrices.pth (local file)."""
    return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# the port's own matrices artifact (rep_matrix_only analog)
# ---------------------------------------------------------------------------


def matrices_state(fq_state: List[LayerFQ]) -> List[LayerFQ]:
    """Freeze a trained FQ state into eval matrices WITHOUT folding the
    diag scales — the reference's rep_matrix_only form
    (llama_utils.py:106-109,317-325): what --save_matrix writes, so that
    a reload baked onto raw weights reproduces the model."""
    return [bake_layer_fq(lfq) for lfq in fq_state]


def matrices_fq_template(cfg: LlamaConfig, fq_cfg: FQConfig, seed: int = 0,
                         tp: int = 1, device="cuda") -> List[LayerFQ]:
    """Structure template for loading a saved matrices artifact."""
    return matrices_state(init_model_fq(cfg, fq_cfg, seed=seed, tp=tp,
                                        device=device))
