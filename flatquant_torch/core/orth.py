"""Orthogonal parameterization via the Cayley map (port of
flatquant_tpu/core/orth.py).

  raw parameter X  ->  A = skew(tril(X, -1))  ->  Q = (I - A/2)^{-1} (I + A/2)

Q is orthogonal for every X. `cayley` runs in float32 torch and is
differentiable; the initialization helpers run on the host in float64
numpy, drawing from an explicit np.random.Generator in JAX's order, so
the same seed gives the same raw parameters in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def cayley(x: torch.Tensor) -> torch.Tensor:
    """Map an unconstrained square matrix to an orthogonal one (float32
    solve of an n x n system; differentiable)."""
    x = x.to(torch.float32)
    a = torch.tril(x, -1)
    a = a - a.T
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(eye - a / 2, eye + a / 2)


def inverse_cayley(q: np.ndarray) -> np.ndarray:
    """Host-side inverse of `cayley` (float64): solves (I + Q) A =
    2 (Q - I) for the skew-symmetric A and returns a raw parameter whose
    strictly-lower triangle carries A."""
    q = np.asarray(q, dtype=np.float64)
    eye = np.eye(q.shape[0])
    a = np.linalg.solve(eye + q, 2.0 * (q - eye))
    a = (a - a.T) / 2.0
    return np.tril(a, -1)


def random_orthogonal(size: int, rng: np.random.Generator) -> np.ndarray:
    """Random special-orthogonal matrix (float64): QR of a gaussian,
    sign-fixed, one column flipped if det = -1."""
    h = rng.standard_normal((size, size))
    q, r = np.linalg.qr(h)
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def random_cayley_param(size: int, rng: np.random.Generator) -> np.ndarray:
    """Raw Cayley parameter (float32) initializing to a random rotation."""
    return inverse_cayley(random_orthogonal(size, rng)).astype(np.float32)
