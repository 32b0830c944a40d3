"""Kronecker-structured transform math (port of
flatquant_tpu/core/kron.py).

A transform of width n is stored as two factors, left [a, a] and right
[b, b] with a * b = n, and applied as x @ kron(left, right): reshape the
last dim to [a, b], multiply by right on the right and by left^T on the
left. The split is fixed at calibration and baked into the serving
params, so a model built for serving must use the split its transforms
were calibrated in.
"""

from __future__ import annotations

import math

import torch


def get_decompose_dim(n: int, rn128: bool = False):
    """Most-square factorization (a - b, a + b) with (a - b)(a + b) = n:
    FlatQuant's default, balanced split. Examples: 4096 -> (64, 64),
    11008 -> (86, 128), 18944 -> (128, 148).

    rn128=True (the tpu_decompose mode): (n / 128, 128) whenever n is a
    multiple of 128 with n / 128 >= 2, else the balanced split."""
    if rn128 and n % 128 == 0 and n // 128 >= 2:
        return n // 128, 128
    a = math.isqrt(n)
    if a * a < n:
        a += 1
    while True:
        diff = a * a - n
        b = math.isqrt(diff)
        if b * b == diff:
            break
        a += 1
    return a - b, a + b


def kronecker_matmul(x, left, right):
    """x @ kron(left, right) for x [..., left_n * right_n]."""
    shape = x.shape
    xm = x.reshape(-1, left.shape[0], right.shape[0])
    xm = xm @ right
    xm = left.T @ xm
    return xm.reshape(shape)


def kronecker_matmul_perm(x, left, right):
    """x @ kron(left, right) with the output channels in transposed
    (j * ln + i) order: out[..., j*ln+i] = (x @ kron)[..., i*rn+j]. Both
    contractions run over the minor dim, with one transpose between them;
    the consumer's weight takes the same permutation of its input
    channels (serving/quantized.py _perm_in_channels)."""
    shape = x.shape
    xm = x.reshape(-1, left.shape[0], right.shape[0])
    xm = xm @ right
    xm = xm.transpose(1, 2)
    xm = xm @ left
    return xm.reshape(shape)


def kron_dense(left, right):
    """Dense kron(left, right), for tests and tiny transforms."""
    return torch.kron(left, right)
