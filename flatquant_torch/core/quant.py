"""Fake-quantization math and the weight quantizer of the real-quant
export (port of flatquant_tpu/core/quant.py).

fp-in, fp-out functions with straight-through gradients (core/ste.py),
used alike by calibration (autograd through the STE), fake-quant eval
and the packer (`weight_find_params` + `weight_quantize_int`).

Conventions, as in JAX:
  - activations quantize per token over the last dim (or per group);
  - weights are [out_features, in_features] and quantize per out
    channel (or per group, or per tensor);
  - the symmetric grid is [-(2^(b-1)), 2^(b-1) - 1], the asymmetric
    [0, 2^b - 1].

Rounding and gradients follow JAX's: every division by a Python number
goes through `true_div` (IEEE division on every device), clips are
jnp.clip's maximum-then-minimum (torch.maximum / torch.minimum split the
gradient in half at a tie, as JAX's do; torch.clamp would not), and
reductions use amax / amin (the gradient shared among tied extrema).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flatquant_torch.core.ste import round_ste


@dataclasses.dataclass(frozen=True)
class ActQuantCfg:
    """Per-token activation quantization config. lac=True: learnable
    clipping (sigmoid(clip_factor) * min / max)."""

    bits: int = 16
    sym: bool = True
    lac: bool = False
    group_size: int = -1  # -1 = whole last dim (per-token)
    clip_ratio: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.bits < 16

    @property
    def q_max(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.sym else 2**self.bits - 1


@dataclasses.dataclass(frozen=True)
class WeightQuantCfg:
    """Per-out-channel weight quantization config (GPTQ-style)."""

    bits: int = 16
    sym: bool = True
    perchannel: bool = True
    group_size: int = -1
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    max_shrink: float = 0.8

    @property
    def enabled(self) -> bool:
        return self.bits < 16

    @property
    def q_max(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.sym else 2**self.bits - 1


def get_qmin_qmax(bits: int, sym: bool) -> Tuple[int, int]:
    if sym:
        q_max = 2 ** (bits - 1) - 1
        return -q_max - 1, q_max
    return 0, 2**bits - 1


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b by IEEE division on every device, as JAX divides. (torch on a
    CUDA tensor multiplies by the reciprocal of a Python-number divisor,
    which can be one float32 ulp off the quotient.)"""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _const(x: torch.Tensor, v) -> torch.Tensor:
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi): maximum then minimum, the gradient halved where
    x ties a bound (lo, hi: numbers or tensors)."""
    lo = lo if torch.is_tensor(lo) else _const(x, lo)
    hi = hi if torch.is_tensor(hi) else _const(x, hi)
    return torch.minimum(hi, torch.maximum(lo, x))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def sym_quant(x, scale, q_max):
    """q = clip(round_ste(x / scale), -(q_max + 1), q_max)."""
    return _clip(round_ste(x / scale), -(q_max + 1), q_max)


def sym_dequant(q, scale):
    return q * scale


def sym_quant_dequant(x, scale, q_max):
    return sym_dequant(sym_quant(x, scale, q_max), scale)


def asym_quant(x, scale, zero, q_max):
    """q = clip(round_ste(x / scale) + zero, 0, q_max)."""
    return _clip(round_ste(x / scale) + zero, 0, q_max)


def asym_dequant(q, scale, zero):
    return scale * (q - zero)


def asym_quant_dequant(x, scale, zero, q_max):
    return asym_dequant(asym_quant(x, scale, zero, q_max), scale, zero)


# ---------------------------------------------------------------------------
# activation quantization (per token / per group over the last dim)
# ---------------------------------------------------------------------------


def _group_reshape(x, group_size: int):
    if group_size > 0:
        if x.shape[-1] % group_size:
            raise ValueError(f"last dim {x.shape[-1]} not divisible by "
                             f"group {group_size}")
        return x.reshape(x.shape[:-1] + (x.shape[-1] // group_size,
                                         group_size))
    return x


def local_reduce(t, dim: int, op: str):
    """The reduction of a row that lies whole in `t`: op "max", "min" or
    "sum" along `dim`, kept. A caller whose rows are split over shards
    passes its own `row_reduce` of this signature, whose result spans
    them (parallel/tp_autograd.py `row_reducer`)."""
    if op == "max":
        return t.amax(dim=dim, keepdim=True)
    if op == "min":
        return t.amin(dim=dim, keepdim=True)
    return t.sum(dim=dim, keepdim=True)


def act_scale_zero(x, cfg: ActQuantCfg, clip_max=None, clip_min=None,
                   row_reduce=None):
    """(scale, zero) of per-token (or per-group) activation quantization,
    each with a trailing singleton axis that broadcasts against the
    group-reshaped x. min / max clamp through zero; LAC multiplies them by
    sigmoid(clip factor), else a static clip_ratio; all-zero rows get
    scale 1 (sym) or the range [-1, 1] (asym). row_reduce: as
    `local_reduce`, for a token whose last dim is split over shards (a
    row-parallel input); a group lies inside a shard and reduces
    locally."""
    xg = _group_reshape(x, cfg.group_size)
    zero_t = _const(xg, 0.0)
    red = row_reduce if row_reduce is not None and cfg.group_size <= 0 \
        else local_reduce
    xmax = torch.maximum(red(xg, -1, "max"), zero_t)
    xmin = torch.minimum(red(xg, -1, "min"), zero_t)
    if cfg.lac and clip_max is not None:
        xmax = xmax * torch.sigmoid(clip_max)
        xmin = xmin * torch.sigmoid(clip_min)
    elif cfg.clip_ratio is not None:
        xmax = xmax * cfg.clip_ratio
        xmin = xmin * cfg.clip_ratio
    q_max = float(cfg.q_max)
    if cfg.sym:
        absmax = torch.maximum(xmin.abs(), xmax)
        scale = torch.where(absmax == 0, 1.0, true_div(absmax, q_max))
        zero = torch.zeros_like(scale)
    else:
        degenerate = (xmin == 0) & (xmax == 0)
        xmin = torch.where(degenerate, -1.0, xmin)
        xmax = torch.where(degenerate, 1.0, xmax)
        scale = true_div(xmax - xmin, q_max)
        zero = torch.round(-xmin / scale)
    return scale, zero


def act_fake_quant(x, cfg: ActQuantCfg, clip_max=None, clip_min=None,
                   enabled: bool = True, row_reduce=None):
    """Fake-quantize activations per token (STE-differentiable); the
    identity when bits >= 16 or not enabled. row_reduce: as
    act_scale_zero."""
    if not cfg.enabled or not enabled:
        return x
    xf = x.to(torch.float32)
    scale, zero = act_scale_zero(xf, cfg, clip_max, clip_min, row_reduce)
    xg = _group_reshape(xf, cfg.group_size)
    if cfg.sym:
        out = sym_quant_dequant(xg, scale, cfg.q_max)
    else:
        out = asym_quant_dequant(xg, scale, zero, cfg.q_max)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# weight quantization (per out channel, optional MSE grid search)
# ---------------------------------------------------------------------------


def _weight_rows(w, cfg: WeightQuantCfg):
    """Rows that each get one scale: [out * groups, group] per group,
    [out, in] per channel, [1, out * in] per tensor."""
    if cfg.perchannel:
        if cfg.group_size > 0:
            return w.reshape(-1, cfg.group_size)
        return w.reshape(w.shape[0], -1)
    return w.reshape(1, -1)


def weight_find_params(w, cfg: WeightQuantCfg, row_reduce=None):
    """(scale, zero) of weight w [out, in], each [rows, 1] float32 (rows as
    `_weight_rows`), with the optional MSE shrink search. Differentiable
    with respect to w. row_reduce: as `local_reduce`, for a weight whose
    in features are split over shards (a row-parallel weight): a row's
    extrema and the search's errors span them (per channel or per
    tensor; a group lies inside a shard and reduces locally)."""
    rows = _weight_rows(w.to(torch.float32), cfg)
    q_max = float(cfg.q_max)
    zero_t = _const(rows, 0.0)
    red = row_reduce if row_reduce is not None and not (
        cfg.perchannel and cfg.group_size > 0) else local_reduce
    xmin = torch.minimum(red(rows, 1, "min")[:, 0], zero_t)
    xmax = torch.maximum(red(rows, 1, "max")[:, 0], zero_t)
    if cfg.sym:
        absmax = _clip(torch.maximum(xmin.abs(), xmax), 1e-5, np.inf)
        scale = true_div(absmax, q_max)
        zero = torch.zeros_like(scale)
    else:
        degenerate = (xmin == 0) & (xmax == 0)
        xmin_ = torch.where(degenerate, -1.0, xmin)
        xmax_ = torch.where(degenerate, 1.0, xmax)
        scale = true_div(_clip(xmax_ - xmin_, 1e-5, np.inf), q_max)
        zero = torch.round(-xmin_ / scale)
    if cfg.mse:
        if cfg.sym:
            scale, zero = _mse_shrink(rows, -absmax, absmax, scale, zero, cfg,
                                      red)
        else:
            scale, zero = _mse_shrink(rows, xmin_, xmax_, scale, zero, cfg,
                                      red)
    return scale[:, None], zero[:, None]


def _mse_shrink(rows, xmin, xmax, scale0, zero0, cfg: WeightQuantCfg,
                row_reduce=local_reduce):
    """Grid search shrinking [xmin, xmax] by p = 1 - i / grid for i <
    int(max_shrink * grid), keeping the first step of least
    sum(|q - w|^norm) per row (strict <, as JAX's loop; the sum by
    row_reduce)."""
    q_max = float(cfg.q_max)
    best = torch.full((rows.shape[0],), float("inf"), dtype=torch.float32,
                      device=rows.device)
    scale, zero = scale0, zero0
    for i in range(int(cfg.max_shrink * cfg.grid)):
        p = float(np.float32(1.0) - np.float32(i) / np.float32(cfg.grid))
        xmin1 = p * xmin
        xmax1 = p * xmax
        if cfg.sym:
            scale1 = true_div(xmax1, q_max)
            zero1 = torch.zeros_like(scale1)
            q = sym_quant_dequant(rows, scale1[:, None], q_max)
        else:
            scale1 = true_div(xmax1 - xmin1, q_max)
            zero1 = torch.round(-xmin1 / scale1)
            q = asym_quant_dequant(rows, scale1[:, None], zero1[:, None],
                                   q_max)
        err = row_reduce((q - rows).abs() ** cfg.norm, 1, "sum")[:, 0]
        better = err < best
        best = torch.where(better, err, best)
        scale = torch.where(better, scale1, scale)
        zero = torch.where(better, zero1, zero)
    return scale, zero


def weight_fake_quant(w, scale, zero, cfg: WeightQuantCfg,
                      enabled: bool = True):
    """Fake-quantize a weight with precomputed (scale, zero) row params."""
    if not cfg.enabled or not enabled:
        return w
    rows = _weight_rows(w.to(torch.float32), cfg)
    if cfg.sym:
        out = sym_quant_dequant(rows, scale, cfg.q_max)
    else:
        out = asym_quant_dequant(rows, scale, zero, cfg.q_max)
    return out.reshape(w.shape).to(w.dtype)


def weight_quantize_int(w, scale, zero, cfg: WeightQuantCfg):
    """Integer codes (no dequant) for the real-quant export, int8: sym
    clip(round(w / scale), -q_max - 1, q_max), asym clip(round(w / scale)
    + zero, 0, q_max). round is half-to-even in both frameworks."""
    rows = _weight_rows(w.to(torch.float32), cfg)
    if cfg.sym:
        q = sym_quant(rows, scale, cfg.q_max)
    else:
        q = asym_quant(rows, scale, zero, cfg.q_max)
    return q.reshape(w.shape).to(torch.int8)
