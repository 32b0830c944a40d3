"""Hadamard transforms, the QuaRot rotation baseline (port of
flatquant_tpu/core/hadamard.py).

Non-power-of-two Hadamard factors are constructed on the host in float64
numpy, as JAX's are:
  - Sylvester doubling for powers of two,
  - Paley I  (order q+1,    q a prime power = 3 mod 4),
  - Paley II (order 2(q+1), q a prime power = 1 mod 4),
  - the published orders with no classical construction, 156 and 172
    (Llama-2-7B's 11008 = 172 * 64), from had_tables.npz (a byte copy of
    the JAX package's file),
  - a doubling of a constructible half order,
and an order with none of these falls back to a seeded random orthogonal
factor (`is_hadamard=False`). get_hadK factors n = K * 2^m.

`fwht` and `matmul_hadU` are plain torch on the input's device (JAX's are
jnp compositions, not a Pallas kernel): a butterfly over the 2^m part and
one K x K matmul.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from flatquant_torch.core.orth import random_orthogonal
from flatquant_torch.kernels.common import resolve_device


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % p for p in range(2, int(n**0.5) + 1))


def _prime_power(n: int):
    """(p, m) with n == p**m, or None."""
    if n < 2:
        return None
    for p in range(2, int(n**0.5) + 1):
        if n % p == 0:
            m, v = 0, n
            while v % p == 0:
                v //= p
                m += 1
            return (p, m) if v == 1 and _is_prime(p) else None
    return (n, 1)


@functools.lru_cache(maxsize=None)
def _gf_ops(q: int):
    """GF(q) subtraction table [q, q] and nonzero-square set [q] (bool).

    Elements are integers whose base-p digits are the coefficients of
    polynomials over GF(p), reduced modulo the first irreducible monic
    polynomial of degree m (found by trial division)."""
    p, m = _prime_power(q)
    if m == 1:
        idx = np.arange(q)
        sub = (idx[:, None] - idx[None, :]) % q
        sq = np.zeros(q, bool)
        sq[(idx[1:] ** 2) % q] = True
        return sub, sq

    def digits(x):
        out = []
        for _ in range(m):
            out.append(x % p)
            x //= p
        return out

    def undigits(ds):
        v = 0
        for d in reversed(ds):
            v = v * p + d
        return v

    def poly_mul_mod(a, b, irred):
        prod = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                prod[i + j] = (prod[i + j] + ai * bj) % p
        for i in range(len(prod) - 1, m - 1, -1):
            c = prod[i]
            if c:
                for j in range(m + 1):
                    prod[i - m + j] = (prod[i - m + j] - c * irred[j]) % p
        return prod[:m]

    def poly_mod(a, b):
        a = list(a)
        db = len(b) - 1
        inv_lead = pow(b[-1], p - 2, p)
        while len(a) - 1 >= db and any(a):
            shift = len(a) - 1 - db
            c = (a[-1] * inv_lead) % p
            for j in range(db + 1):
                a[shift + j] = (a[shift + j] - c * b[j]) % p
            while len(a) > 1 and a[-1] == 0:
                a.pop()
        return a

    def is_irreducible(f):
        for deg in range(1, m // 2 + 1):
            for t in range(p**deg):
                r = poly_mod(f, digits(t)[:deg] + [1])
                if len(r) == 1 and r[0] == 0:
                    return False
        return True

    irred = next(c for c in (digits(t) + [1] for t in range(p**m))
                 if is_irreducible(c))
    elems = [digits(x) for x in range(q)]
    sub = np.zeros((q, q), np.int64)
    for i in range(q):
        for j in range(q):
            sub[i, j] = undigits([(a - b) % p
                                  for a, b in zip(elems[i], elems[j])])
    sq = np.zeros(q, bool)
    for x in range(1, q):
        sq[undigits(poly_mul_mod(elems[x], elems[x], irred))] = True
    return sub, sq


def _jacobsthal(q: int) -> np.ndarray:
    """Q[i, j] = chi(e_i - e_j) over GF(q), chi the quadratic character."""
    sub, sq = _gf_ops(q)
    chi = np.where(sq[sub], 1, -1)
    chi[sub == 0] = 0
    return chi.astype(np.int8)


def paley1(q: int) -> np.ndarray:
    """Paley I Hadamard of order q+1 (q a prime power, q = 3 mod 4)."""
    if _prime_power(q) is None or q % 4 != 3:
        raise ValueError(f"Paley I needs a prime power = 3 mod 4, got {q}")
    n = q + 1
    h = np.ones((n, n), np.int8)
    h[1:, 1:] = _jacobsthal(q) + np.eye(q, dtype=np.int8)
    h[1:, 0] = -1
    return h.astype(np.float64)


def paley2(q: int) -> np.ndarray:
    """Paley II Hadamard of order 2(q+1) (q a prime power, q = 1 mod 4)."""
    if _prime_power(q) is None or q % 4 != 1:
        raise ValueError(f"Paley II needs a prime power = 1 mod 4, got {q}")
    m = q + 1
    s = np.zeros((m, m), np.int8)
    s[0, 1:] = 1
    s[1:, 0] = 1
    s[1:, 1:] = _jacobsthal(q)
    # block substitution: S entries 0 -> B, +-1 -> +-A
    a = np.array([[1, 1], [1, -1]], np.int8)
    b = np.array([[1, -1], [-1, -1]], np.int8)
    h = np.zeros((2 * m, 2 * m), np.int8)
    for i in range(m):
        for j in range(m):
            h[2 * i:2 * i + 2, 2 * j:2 * j + 2] = (b if s[i, j] == 0
                                                   else s[i, j] * a)
    return h.astype(np.float64)


def _load_had_table(k: int) -> Optional[np.ndarray]:
    """The published order-k matrix from had_tables.npz (bit-packed, key
    "h<k>"), or None."""
    path = os.path.join(os.path.dirname(__file__), "had_tables.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        key = f"h{k}"
        if key not in z:
            return None
        bits = np.unpackbits(z[key])[:k * k].reshape(k, k)
    return bits.astype(np.float64) * 2.0 - 1.0


@functools.lru_cache(maxsize=None)
def hadamard_matrix(k: int, seed: int = 0) -> Tuple[np.ndarray, bool]:
    """(K x K float64 factor, is_hadamard): unnormalized +-1 where a
    construction applies, else a random orthogonal matrix times sqrt(K)
    drawn from np.random.default_rng(seed + k)."""
    if k == 1:
        return np.ones((1, 1)), True
    if k & (k - 1) == 0:
        h = np.array([[1.0]])
        while h.shape[0] < k:
            h = np.block([[h, h], [h, -h]])
        return h, True
    if k % 4 == 0:
        tab = _load_had_table(k)
        if tab is not None:
            return tab, True
        if _prime_power(k - 1) and (k - 1) % 4 == 3:
            return paley1(k - 1), True
        if _prime_power(k // 2 - 1) and (k // 2 - 1) % 4 == 1:
            return paley2(k // 2 - 1), True
        sub, ok = hadamard_matrix(k // 2, seed)
        if ok:
            return np.block([[sub, sub], [sub, -sub]]), True
    rng = np.random.default_rng(seed + k)
    return random_orthogonal(k, rng) * np.sqrt(k), False


def get_hadK(n: int, seed: int = 0) -> Tuple[Optional[np.ndarray], int, bool]:
    """Factor n = K * 2^m: (the K factor, or None when K == 1, K,
    is_hadamard), K the odd part of n times the least of 4, 8, 16 that
    divides n."""
    k = n
    while k % 2 == 0:
        k //= 2
    if k == 1:
        return None, 1, True
    for mult in (4, 8, 16):
        kk = k * mult
        if n % kk == 0:
            mat, is_had = hadamard_matrix(kk, seed)
            return mat, kk, is_had
    raise ValueError(f"cannot factor {n} for a Hadamard transform")


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform over the last dim (a
    power of two), JAX's butterfly order."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"fwht needs a power of two, got {n}")
    shape = x.shape
    y = x.reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    return y.reshape(shape)


def matmul_hadU(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """x @ H_n / sqrt(n), H_n = hadK (x) H_{2^m}: the butterfly over the
    2^m part, one K x K matmul, one division by sqrt(n) in x's dtype."""
    n = x.shape[-1]
    mat, k, _ = get_hadK(n)
    shape = x.shape
    xk = fwht(x.reshape(-1, k, n // k))
    if mat is not None:
        m = torch.as_tensor(mat, dtype=x.dtype, device=x.device)
        xk = torch.einsum("ik,bkj->bij", m.T, xk)
    # JAX divides by float32 sqrt(n) cast to x's dtype
    root = torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    return (xk / root.to(device=x.device, dtype=x.dtype)).reshape(shape)


def random_hadamard_matrix(n: int, seed: int = 0, device="cuda"):
    """Normalized Hadamard composed with a random sign diagonal (QuaRot's
    randomized rotation), float32 [n, n] on `device`."""
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], size=n)
    eye = torch.as_tensor(np.diag(signs), dtype=torch.float32,
                          device=resolve_device(device))
    return matmul_hadU(eye, seed=seed)


def apply_had_to_weight(w: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Fuse the rotation into a weight's in-features, W <- W @ H: with H
    orthogonal, (x H)(W H)^T = x W^T."""
    return matmul_hadU(w, seed=seed)
