"""Quantizer configs and the weight quantizer of the real-quant export.

Port of flatquant_tpu/core/quant.py, limited to what packing a serving
model needs: the two config dataclasses and the symmetric per-channel
path of weight_find_params / weight_quantize_int. The fake-quant (STE)
functions and the MSE grid search arrive with the calibration chain
(ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_BUILD_CHAIN = "ROADMAP queue 1 item 4 (build chain)"


@dataclasses.dataclass(frozen=True)
class ActQuantCfg:
    """Per-token activation quantization config."""

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


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b by IEEE division on every device, as JAX divides. (torch on a
    CUDA tensor multiplies by the reciprocal of a Python-number divisor,
    which can be one float32 ulp off the quotient.)"""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _check_sym_perchannel(cfg: WeightQuantCfg):
    if not (cfg.sym and cfg.perchannel and cfg.group_size <= 0 and not cfg.mse):
        raise NotImplementedError(
            f"only symmetric per-channel weights without MSE search are "
            f"ported; {cfg} waits for {_BUILD_CHAIN}")


def weight_find_params(w: torch.Tensor, cfg: WeightQuantCfg
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero) of weight w [out, in], each [out, 1] float32.

    absmax = max(|min(w, 0)|, max(w, 0)) clipped at 1e-5, scale =
    absmax / q_max (flatquant_tpu/core/quant.py:216-238)."""
    _check_sym_perchannel(cfg)
    rows = w.to(torch.float32).reshape(w.shape[0], -1)
    xmin = torch.clamp(rows.amin(dim=1), max=0.0)
    xmax = torch.clamp(rows.amax(dim=1), min=0.0)
    absmax = torch.maximum(xmin.abs(), xmax).clamp(min=1e-5)
    scale = true_div(absmax, float(cfg.q_max))
    return scale[:, None], torch.zeros_like(scale)[:, None]


def weight_quantize_int(w: torch.Tensor, scale: torch.Tensor,
                        zero: torch.Tensor, cfg: WeightQuantCfg
                        ) -> torch.Tensor:
    """Integer codes clamp(round(w / scale), -q_max-1, q_max) as int8
    (flatquant_tpu/core/quant.py:300-307). round is half-to-even in both
    frameworks."""
    _check_sym_perchannel(cfg)
    rows = w.to(torch.float32).reshape(w.shape[0], -1)
    q = torch.clamp(torch.round(rows / scale), -(cfg.q_max + 1), cfg.q_max)
    return q.reshape(w.shape).to(torch.int8)
