"""Learnable invertible transforms, the "flat" in FlatQuant (port of
flatquant_tpu/core/transforms.py).

  - a factor is one learnable square matrix. SVDFactor stores (u, v, d)
    with U = cayley(u), V = cayley(v), P = U diag(d) V^T and the closed
    form P^{-T} = U diag(1/d) V^T; InvFactor stores P and inverts it in
    float32 with one Newton step (`_newton_inv`).
  - SingleTransform: one dense n x n factor (the head-dim and head
    transforms).
  - DecomposeTransform: a Kronecker pair left (x) right with an optional
    per-channel diag scale applied before the product.
  - bake_single / bake_decompose freeze the factors into fixed matrices
    for eval and serving (BakedSingle, BakedDecompose).

Parameters are dataclasses of float32 tensors; applications cast the
matrix to the activation's dtype, as JAX does. The init functions draw
on the host (core/orth.py, numpy float64, JAX's order) and put the
tensors on `device` (default "cuda").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from flatquant_torch.core.kron import (
    get_decompose_dim,
    kronecker_matmul,
    kronecker_matmul_perm,
)
from flatquant_torch.core.orth import (
    cayley,
    random_cayley_param,
    random_orthogonal,
)
from flatquant_torch.kernels.common import resolve_device


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SVDFactor:
    """P = cayley(u) @ diag(d) @ cayley(v)^T."""

    u: torch.Tensor  # raw cayley param [n, n]
    v: torch.Tensor  # raw cayley param [n, n]
    d: torch.Tensor  # diagonal [n]

    @property
    def size(self) -> int:
        return self.d.shape[0]


@dataclasses.dataclass
class InvFactor:
    """P stored raw; its inverse computed numerically (direct_inv)."""

    m: torch.Tensor  # [n, n]

    @property
    def size(self) -> int:
        return self.m.shape[0]


Factor = Union[SVDFactor, InvFactor]


def _newton_inv(m):
    """float32 inverse with one Newton step: X <- X (2I - M X)."""
    m = m.to(torch.float32)
    x = torch.linalg.inv(m)
    eye2 = 2.0 * torch.eye(m.shape[0], dtype=torch.float32, device=m.device)
    return x @ (eye2 - m @ x)


def factor_matrix(f: Factor, inv_t: bool = False):
    """The factor's float32 matrix, or its inverse-transpose."""
    if isinstance(f, SVDFactor):
        u = cayley(f.u)
        v = cayley(f.v)
        d = torch.ones_like(f.d) / f.d if inv_t else f.d
        return (u * d[None, :]) @ v.T
    if isinstance(f, InvFactor):
        return _newton_inv(f.m).T if inv_t else f.m.to(torch.float32)
    raise TypeError(f"unknown factor {type(f)}")


def init_svd_factor(size: int, rng: np.random.Generator,
                    device="cuda") -> SVDFactor:
    dev = resolve_device(device)
    u = random_cayley_param(size, rng)
    v = random_cayley_param(size, rng)
    return SVDFactor(u=torch.tensor(u, device=dev),
                     v=torch.tensor(v, device=dev),
                     d=torch.ones(size, dtype=torch.float32, device=dev))


def init_inv_factor(size: int, rng: np.random.Generator,
                    device="cuda") -> InvFactor:
    m = random_orthogonal(size, rng).astype(np.float32)
    return InvFactor(m=torch.tensor(m, device=resolve_device(device)))


# ---------------------------------------------------------------------------
# single transform (dense n x n)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SingleTransform:
    factor: Factor

    @property
    def size(self) -> int:
        return self.factor.size


@dataclasses.dataclass
class BakedSingle:
    matrix: torch.Tensor
    matrix_inv_t: torch.Tensor

    @property
    def size(self) -> int:
        return self.matrix.shape[0]


AnySingle = Union[SingleTransform, BakedSingle]


def single_matrix(t: AnySingle, inv_t: bool = False):
    if isinstance(t, BakedSingle):
        return t.matrix_inv_t if inv_t else t.matrix
    return factor_matrix(t.factor, inv_t)


def apply_single(t: AnySingle, x, inv_t: bool = False):
    """x @ P over the last dim (any leading dims)."""
    mat = single_matrix(t, inv_t).to(x.dtype)
    shape = x.shape
    return (x.reshape(-1, mat.shape[0]) @ mat).reshape(shape)


def bake_single(t: AnySingle) -> BakedSingle:
    if isinstance(t, BakedSingle):
        return t
    return BakedSingle(matrix=single_matrix(t, False),
                       matrix_inv_t=single_matrix(t, True))


def init_single(size: int, rng: np.random.Generator,
                direct_inv: bool = False, device="cuda") -> SingleTransform:
    mk = init_inv_factor if direct_inv else init_svd_factor
    return SingleTransform(factor=mk(size, rng, device))


# ---------------------------------------------------------------------------
# decomposed (Kronecker) transform
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecomposeTransform:
    left: Factor
    right: Factor
    diag_scale: Optional[torch.Tensor]  # [left_n * right_n] or None

    @property
    def size(self) -> int:
        return self.left.size * self.right.size


@dataclasses.dataclass
class BakedDecompose:
    left: torch.Tensor
    right: torch.Tensor
    left_inv: torch.Tensor  # left^{-T}
    right_inv: torch.Tensor  # right^{-T}
    diag_scale: Optional[torch.Tensor] = None  # None once folded
    # serving layout: emit the transposed (j*ln+i) channel order through
    # kronecker_matmul_perm; weight folds run through the same
    # apply_decompose, so activations and folded weights agree
    perm: bool = False

    @property
    def size(self) -> int:
        return self.left.shape[0] * self.right.shape[0]


AnyDecompose = Union[DecomposeTransform, BakedDecompose]


def decompose_matrices(t: AnyDecompose, inv_t: bool = False):
    if isinstance(t, BakedDecompose):
        return (t.left_inv, t.right_inv) if inv_t else (t.left, t.right)
    return factor_matrix(t.left, inv_t), factor_matrix(t.right, inv_t)


def apply_decompose(t: AnyDecompose, x, inv_t: bool = False,
                    use_diag: bool = True):
    """x * diag_scale (x / diag_scale for inv_t), then x @ kron(left,
    right) (the inverse-transposes for inv_t), each matrix cast to x's
    dtype; perm=True emits the transposed channel order. A diag narrower
    than x tiles across it (shard-aligned transforms)."""
    if t.diag_scale is not None and use_diag:
        d = t.diag_scale.to(x.dtype)
        if d.shape[0] != x.shape[-1]:
            if x.shape[-1] % d.shape[0]:
                raise ValueError(f"diag of {d.shape[0]} does not tile "
                                 f"{x.shape[-1]} channels")
            d = d.repeat(x.shape[-1] // d.shape[0])
        x = x / d if inv_t else x * d
    left, right = decompose_matrices(t, inv_t)
    mm = kronecker_matmul_perm if getattr(t, "perm", False) \
        else kronecker_matmul
    return mm(x, left.to(x.dtype), right.to(x.dtype))


def bake_decompose(t: AnyDecompose, perm: bool = False) -> BakedDecompose:
    if isinstance(t, BakedDecompose):
        return t if t.perm == perm else dataclasses.replace(t, perm=perm)
    left, right = decompose_matrices(t, False)
    left_inv, right_inv = decompose_matrices(t, True)
    return BakedDecompose(left=left, right=right, left_inv=left_inv,
                          right_inv=right_inv, diag_scale=t.diag_scale,
                          perm=perm)


def init_decompose(size: int, rng: np.random.Generator,
                   add_diag: bool = False, direct_inv: bool = False,
                   diag_init: Optional[np.ndarray] = None,
                   rn128: bool = False, device="cuda") -> DecomposeTransform:
    """Left then right factor, each from `rng` (u then v for SVD
    factors), in JAX's order."""
    dev = resolve_device(device)
    ln, rn = get_decompose_dim(size, rn128=rn128)
    mk = init_inv_factor if direct_inv else init_svd_factor
    left = mk(ln, rng, dev)
    right = mk(rn, rng, dev)
    diag = None
    if add_diag:
        diag = (torch.ones(size, dtype=torch.float32, device=dev)
                if diag_init is None else
                torch.tensor(np.asarray(diag_init, np.float32), device=dev))
    return DecomposeTransform(left=left, right=right, diag_scale=diag)
