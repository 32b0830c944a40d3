"""Baked Kronecker transforms on the activation side (the serving part of
flatquant_tpu/core/transforms.py: BakedDecompose and apply_decompose).

A baked transform holds fixed factors left [a, a] and right [b, b], their
inverse-transposes, and an optional per-channel diag scale applied before
the Kronecker product. Serving applies it to an activation x [..., a*b]
as x * diag, then x @ kron(left, right). The learnable factors, their
baking and the one-copy permuted layout (`perm=True`, with
kronecker_matmul_perm) arrive with the build chain (ROADMAP queue 1
item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flatquant_torch.serving.quantized import kron_transform


@dataclasses.dataclass
class BakedDecompose:
    left: torch.Tensor
    right: torch.Tensor
    left_inv: torch.Tensor  # left^{-T}
    right_inv: torch.Tensor  # right^{-T}
    diag_scale: Optional[torch.Tensor] = None
    perm: bool = False


def apply_decompose(t: BakedDecompose, x):
    """x * diag_scale, then x @ kron(left, right), each matrix cast to x's
    dtype as JAX casts it. A diag narrower than x tiles across it
    (shard-aligned transforms). The inverse side (weight folds) is the
    build chain's."""
    if t.perm:
        raise NotImplementedError(
            "perm_transforms (kronecker_matmul_perm) waits for ROADMAP "
            "queue 1 item 4")
    if t.diag_scale is not None:
        d = t.diag_scale.to(x.dtype)
        if d.shape[0] != x.shape[-1]:
            if x.shape[-1] % d.shape[0]:
                raise ValueError(f"diag of {d.shape[0]} does not tile "
                                 f"{x.shape[-1]} channels")
            d = d.repeat(x.shape[-1] // d.shape[0])
        x = x * d
    return kron_transform(x, (t.left.to(x.dtype), t.right.to(x.dtype)))
