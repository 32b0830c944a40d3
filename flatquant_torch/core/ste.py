"""Straight-through estimators for quantization (port of
flatquant_tpu/core/ste.py).

Both are x + (op(x) - x).detach(): the forward value is op(x), the
gradient is 1 everywhere, as JAX's stop_gradient form gives.
"""

from __future__ import annotations

import torch


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even (torch.round, as jnp.round), with a
    straight-through gradient of 1."""
    return x + (torch.round(x) - x).detach()


def clamp_ste(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clamp with a straight-through gradient of 1 everywhere."""
    return x + (torch.clamp(x, lo, hi) - x).detach()
