"""Quantized linear as functions: the FlatQuantizedLinear analog (port of
flatquant_tpu/quantize/linear.py).

A linear's quant state holds only its learnable clip factors; weights
live in the model params, transforms in the layer's FQ state. The train
forward re-derives the weight scales every call (STE through round,
gradients to the transforms and clips, the scales inside the autograd
graph); `bake_linear_weight` reproduces reparameterize(): transform and
clip applied once in float32, after which eval forwards are act quant +
a plain matmul.

Weight layout [out_features, in_features]; the matmul is x @ W^T.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from flatquant_torch.core.kron import kronecker_matmul
from flatquant_torch.core.quant import (
    ActQuantCfg,
    WeightQuantCfg,
    _clip,
    act_fake_quant,
    local_reduce,
    weight_fake_quant,
    weight_find_params,
)
from flatquant_torch.core.transforms import (
    AnyDecompose,
    AnySingle,
    apply_decompose,
    apply_single,
)
from flatquant_torch.kernels.common import resolve_device

CLIP_INIT = 4.0  # sigmoid(4) ~ 0.982, flat_linear.py:21-23


@dataclasses.dataclass
class LinearQuantState:
    """Learnable clip factors of one quantized linear (None = off)."""

    clip_w_max: Optional[torch.Tensor]  # [out, 1] raw (sigmoid applied)
    clip_w_min: Optional[torch.Tensor]  # [out, 1]
    clip_a_max: Optional[torch.Tensor]  # [1]
    clip_a_min: Optional[torch.Tensor]  # [1]


def init_linear_state(out_features: int, lwc: bool, lac: bool,
                      device="cuda") -> LinearQuantState:
    dev = resolve_device(device)

    def full(*shape):
        return torch.full(shape, CLIP_INIT, dtype=torch.float32, device=dev)

    return LinearQuantState(
        clip_w_max=full(out_features, 1) if lwc else None,
        clip_w_min=full(out_features, 1) if lwc else None,
        clip_a_max=full(1) if lac else None,
        clip_a_min=full(1) if lac else None)


def _apply_wclip(w, st: LinearQuantState, row_reduce=None):
    """Learnable weight clipping: clip to sigmoid(c) * the row's min and
    max (row_reduce: core/quant.py's hook, for rows split over shards)."""
    red = row_reduce or local_reduce
    return _clip(w, red(w, 1, "min") * torch.sigmoid(st.clip_w_min),
                 red(w, 1, "max") * torch.sigmoid(st.clip_w_max))


QaTrans = Union[AnyDecompose, Sequence[torch.Tensor], None]


def _apply_qa_trans(w, qa_trans: QaTrans):
    """W @ P^{-T} over the in-features: a Decompose transform (inv_t) or
    an explicit (left, right) pair already inverse-transposed (the o_proj
    case: [o_trans^{-T} over heads, vcache_trans^{-T} over head_dim])."""
    if qa_trans is None:
        return w
    if isinstance(qa_trans, (tuple, list)):
        left, right = qa_trans
        return kronecker_matmul(w, left.to(w.dtype), right.to(w.dtype))
    return apply_decompose(qa_trans, w, inv_t=True)


def transform_weight(w, st: Optional[LinearQuantState],
                     qa_trans: QaTrans = None,
                     out_trans: Optional[AnySingle] = None,
                     lwc: bool = False, row_reduce=None):
    """Transform and clip a weight in float32 (shared by the train forward
    and the bake). row_reduce: core/quant.py's hook, when w holds one
    shard of its in features (qa_trans then acts on that block alone)."""
    w = w.to(torch.float32)
    w = _apply_qa_trans(w, qa_trans)
    if lwc and st is not None and st.clip_w_max is not None:
        w = _apply_wclip(w, st, row_reduce)
    if out_trans is not None:
        # a Single transform on the output dim (per-head blocks)
        w = apply_single(out_trans, w.T).T
    return w


def fq_linear_train(x, w, bias, st: LinearQuantState, w_cfg: WeightQuantCfg,
                    a_cfg: ActQuantCfg, qa_trans: QaTrans = None,
                    out_trans: Optional[AnySingle] = None, lwc: bool = False,
                    row_reduce=None):
    """Calibration forward: fake-quantize the transformed weight (its
    scales re-derived in the autograd graph, as the reference's
    find_params-per-step) and the activation, then the matmul.
    row_reduce: core/quant.py's hook, when x and w hold one shard of the
    in features (a row-parallel linear): every per-row reduction spans
    the shards, and the product is this shard's partial sum."""
    wt = transform_weight(w, st, qa_trans, out_trans, lwc, row_reduce)
    scale, zero = weight_find_params(wt, w_cfg, row_reduce)
    wq = weight_fake_quant(wt, scale, zero, w_cfg)
    xq = act_fake_quant(x, a_cfg, st.clip_a_max, st.clip_a_min,
                        row_reduce=row_reduce)
    y = xq @ wq.T.to(xq.dtype)
    if bias is not None:
        b = apply_single(out_trans, bias) if out_trans is not None else bias
        y = y + b.to(y.dtype)
    return y


def fq_linear_eval(x, w, bias, st: LinearQuantState, a_cfg: ActQuantCfg,
                   row_reduce=None):
    """Eval forward on baked weights: act quant + a plain linear
    (row_reduce: as fq_linear_train)."""
    xq = act_fake_quant(x, a_cfg, st.clip_a_max, st.clip_a_min,
                        row_reduce=row_reduce)
    y = xq @ w.T.to(xq.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def bake_linear_weight(w, st: Optional[LinearQuantState],
                       w_cfg: WeightQuantCfg, qa_trans: QaTrans = None,
                       out_trans: Optional[AnySingle] = None,
                       lwc: bool = False, rtn: bool = True):
    """reparameterize(): transform and clip baked into the weight once
    (float32); rtn=True also applies round-to-nearest weight fake-quant."""
    wt = transform_weight(w, st, qa_trans, out_trans, lwc)
    if rtn and w_cfg.enabled:
        scale, zero = weight_find_params(wt, w_cfg)
        wt = weight_fake_quant(wt, scale, zero, w_cfg)
    return wt
