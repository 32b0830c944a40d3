"""The Kronecker split of a transform dimension (the port's own copy of
flatquant_tpu/core/kron.py:get_decompose_dim).

A transform of width n is stored as two factors, left [a, a] and right
[b, b] with a * b = n, and applied as x @ kron(left, right). The split
is fixed at calibration and baked into the serving params, so a model
built for serving must use the split its transforms were calibrated in.
"""

from __future__ import annotations

import math


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
