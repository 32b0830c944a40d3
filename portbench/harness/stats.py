"""Window arithmetic: percentiles and whole-window rates."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float):
    """The q-th percentile, linearly interpolated between the closest
    ranks (numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def rate(count: float, t0: float, t1: float):
    """count over the window's seconds."""
    return count / (t1 - t0) if t1 > t0 else None


def in_window(t: float, win: dict) -> bool:
    return win["t0"] < t <= win["t1"]
