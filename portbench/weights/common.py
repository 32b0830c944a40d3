"""Seeded stand-ins for a calibrated FlatQuant model, made on the device.

Both sides of a run take their inputs from here: the program's build
(families/) and the plain reference (reference/). Each layer has a
generator of its own, seeded from the run's seed and the layer's index,
so the reference makes any layer again without the others. Imports
torch only.
"""

from __future__ import annotations

import math

import torch

_MASK = (1 << 64) - 1


def stream_seed(seed: int, index: int) -> int:
    """A generator seed for part `index` of run `seed` (splitmix64 of
    both; any whole seed, negative or past 64 bits, is taken mod 2**64)."""
    z = ((seed & _MASK) * 0x9E3779B97F4A7C15 + index + 1) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, index))


def kron_split(n: int):
    """FlatQuant's balanced Kronecker split (a - b, a + b) of n, the most
    square one: 3584 -> (56, 64), 18944 -> (128, 148), 2048 -> (32, 64)."""
    a = math.isqrt(n)
    if a * a < n:
        a += 1
    while True:
        d = a * a - n
        b = math.isqrt(d)
        if b * b == d:
            return a - b, a + b
        a += 1


def bf16_normal(gen, shape, std, device):
    """N(0, std^2) rounded to bf16, held in float32: a bf16 checkpoint's
    values."""
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * std).to(torch.bfloat16).to(torch.float32)


def near_one(gen, n, sigma, device):
    """A norm weight 1 + N(0, sigma^2), rounded to bf16, in float32."""
    t = torch.randn((n,), generator=gen, device=device, dtype=torch.float32)
    return (1.0 + sigma * t).to(torch.bfloat16).to(torch.float32)


def factor(gen, n, sigma, device):
    """A FlatQuant SVD factor at a calibrated-looking point: P = U diag(s)
    V^T with U, V random orthogonal and s = exp(sigma N(0, 1)). Returns
    (P, P^{-T}) in float32, both from the float64 factors."""
    def orth():
        q, r = torch.linalg.qr(torch.randn((n, n), generator=gen,
                                           device=device,
                                           dtype=torch.float64))
        return q * torch.sign(torch.diagonal(r))

    u, v = orth(), orth()
    s = torch.exp(sigma * torch.randn((n,), generator=gen, device=device,
                                      dtype=torch.float64))
    p = (u * s) @ v.T
    p_inv_t = (u / s) @ v.T
    return p.to(torch.float32), p_inv_t.to(torch.float32)


def kron_pair(gen, n, sigma, device):
    """A Kronecker transform of width n in the balanced split: ((L,
    L^{-T}), (R, R^{-T}))."""
    ln, rn = kron_split(n)
    return factor(gen, ln, sigma, device), factor(gen, rn, sigma, device)


def clip_ratio(raw: float) -> float:
    """A LAC / LWC clip ratio: sigmoid of its raw factor."""
    return 1.0 / (1.0 + math.exp(-raw))
