"""Conversion of the JAX package's serving params into the port's.

The JAX package stacks every layer leaf on a leading [L] axis (for
lax.scan); the port keeps a list of per-layer dicts. Only numpy arrays
cross the boundary: callers pass `jax.tree.map(np.asarray, sp)`, so this
module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from flatquant_torch.kernels.common import resolve_device


def _to_torch(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy takes; the
        # widening to float32 and the cast back are both exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.tensor(a, device=dev)


def _convert(tree, dev, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dev, index) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, dev, index) for v in tree)
    if tree is None:
        return None
    return _to_torch(tree if index is None else np.asarray(tree)[index], dev)


def from_jax_serving_params(sp_numpy: dict, device="cuda") -> dict:
    """JAX serving params as numpy arrays (stacked over layers, or a
    per-layer list from unstack_serving_layers) -> the port's params on
    `device`: {"embed", "final_norm_w", "lm_head", "layers": [dict]}."""
    dev = resolve_device(device)
    layers = sp_numpy["layers"]
    if isinstance(layers, dict):
        n = np.asarray(layers["ln1_w"]).shape[0]
        per_layer = [_convert(layers, dev, i) for i in range(n)]
    else:
        per_layer = [_convert(lp, dev) for lp in layers]
    out = {k: _convert(v, dev) for k, v in sp_numpy.items() if k != "layers"}
    out["layers"] = per_layer
    return out
