"""Conversion of the JAX package's fp params, FlatQuant state and
serving params (the Llama engine's, the bf16 comparator's and
DeepSeek's) into the port's, and of serving caches in both directions.

The JAX package stacks every layer leaf on a leading [L] axis (for
lax.scan); the port keeps a list of per-layer dicts (params) or tensors
(caches). Only numpy arrays cross the boundary: callers pass
`jax.tree.map(np.asarray, sp)`, so this module never imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flatquant_torch.core import transforms as _tr
from flatquant_torch.core.transforms import BakedDecompose
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.quantize import linear as _lin
from flatquant_torch.quantize import state as _st


def _to_torch(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        # ml_dtypes' float8 crosses as its bytes
        return torch.tensor(np.ascontiguousarray(a).view(np.uint8),
                            device=dev).view(torch.float8_e4m3fn)
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
    `device`: {"embed", "final_norm_w", "lm_head", "layers": [dict]}.
    The bf16 comparator's params (serving/baseline.py build_bf16_params)
    are the same tree and convert through this function too."""
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


def from_jax_params(params_numpy: dict, device="cuda") -> dict:
    """JAX's fp (or baked) Llama params as numpy arrays, each layer leaf
    stacked on [L] -> the port's {"embed", "final_norm_w"[, "lm_head"],
    "layers": [per-layer dict]} on `device`, values unchanged."""
    return from_jax_serving_params(params_numpy, device)


# the FlatQuant state's classes, by the name both packages give them
_FQ_CLASSES = {cls.__name__: cls for cls in (
    _tr.SVDFactor, _tr.InvFactor, _tr.SingleTransform, _tr.BakedSingle,
    _tr.DecomposeTransform, _tr.BakedDecompose, _lin.LinearQuantState,
    _st.CacheQuantState, _st.AttnFQ, _st.MlpFQ, _st.LayerFQ)}


def _first_array(tree):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            a = _first_array(getattr(tree, f.name))
            if a is not None:
                return a
        return None
    if tree is None or isinstance(tree, (bool, int, float)):
        return None
    return np.asarray(tree)


def _fq_layer(tree, i, dev):
    if dataclasses.is_dataclass(tree):
        cls = _FQ_CLASSES[type(tree).__name__]
        return cls(**{f.name: _fq_layer(getattr(tree, f.name), i, dev)
                      for f in dataclasses.fields(cls)})
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    return _to_torch(np.asarray(tree)[i], dev)


def from_jax_fq(fq_numpy, device="cuda") -> list:
    """JAX's LayerFQ state, raw (init_model_fq) or baked (bake_model),
    stacked on [L] with numpy leaves (jax.tree.map(np.asarray, fq)) -> the
    port's list of LayerFQ on `device`: the same classes by name and
    field, values unchanged (None stays None, BakedDecompose.perm
    carried)."""
    dev = resolve_device(device)
    n = _first_array(fq_numpy).shape[0]
    return [_fq_layer(fq_numpy, i, dev) for i in range(n)]


def from_jax_ds_serving_params(sp_numpy: dict, device="cuda") -> dict:
    """JAX DeepSeek params as numpy arrays, stacked over layers (raw
    bf16/f32 params, build_ds_fp8_serving_params' fp8 dicts or
    build_ds_serving_params' packed int4 dicts with their a_clip pairs) ->
    the port's: {"embed", "final_norm", "head", "dense_layers": [dict],
    "moe_layers": [dict]}. float8 codes cross byte for byte."""
    dev = resolve_device(device)
    out = {k: _convert(v, dev) for k, v in sp_numpy.items()
           if k not in ("dense_layers", "moe_layers")}
    for key in ("dense_layers", "moe_layers"):
        stacked = sp_numpy[key]
        n = np.asarray(stacked["attn_norm"]).shape[0]
        out[key] = [_convert(stacked, dev, i) for i in range(n)]
    return out


_DS_TRANSFORMS = {"attn": ("qkv_trans", "wqb_trans", "wo_trans"),
                  "ffn": ("up_gate_trans", "down_trans", "w1_trans",
                          "w2_trans", "routed_w2_trans")}


def _baked(t, i, dev):
    if t is None:
        return None
    if not hasattr(t, "left_inv"):
        raise ValueError(f"{type(t).__name__} is not baked: convert the "
                         "output of bake_ds_fq / build_ds_serving_params")

    def pick(a):
        return None if a is None else _to_torch(np.asarray(a)[i], dev)

    return BakedDecompose(left=pick(t.left), right=pick(t.right),
                          left_inv=pick(t.left_inv),
                          right_inv=pick(t.right_inv),
                          diag_scale=pick(t.diag_scale),
                          perm=bool(getattr(t, "perm", False)))


def from_jax_ds_fq(fq_numpy, device="cuda"):
    """JAX's baked DeepSeek state (dense_fq, moe_fq), stacks of
    DSDenseLayerFQ / DSMoELayerFQ with numpy leaves (jax.tree.map(
    np.asarray, baked)) -> the port's (dense_fq, moe_fq): lists of
    per-layer {"attn": {...}, "ffn": {...}} dicts of BakedDecompose (None
    where JAX has none). Only the transforms cross: the serving forward
    reads no linear state."""
    dev = resolve_device(device)
    out = []
    for stack in fq_numpy:
        if stack is None:
            out.append(None)
            continue
        parts = {part: {k: getattr(getattr(stack, part), k)
                        for k in keys if hasattr(getattr(stack, part), k)}
                 for part, keys in _DS_TRANSFORMS.items()}
        lefts = [t.left for p in parts.values() for t in p.values()
                 if t is not None]
        n = np.asarray(lefts[0]).shape[0] if lefts else 0
        out.append([{part: {k: _baked(t, i, dev) for k, t in p.items()}
                     for part, p in parts.items()} for i in range(n)])
    return tuple(out)


# the packed cache's keys; JAX keeps their token index last (v4 layout:
# slot cache [L, B, nkv, hd/2 | 2, S], pool [L, nb, nkv, hd/2 | 2, bs]),
# the port second to last, per layer
_PACKED = ("kp", "kparam", "vp", "vparam")


def from_jax_cache(cache_numpy: dict, device="cuda") -> dict:
    """A JAX serving cache as numpy arrays (int4 slot cache, paged pool
    with or without "tbl", or bf16 cache; stacked [L, ...] or per-layer
    tuples) -> the port's cache dict of per-layer tensors on `device`:
    codes and params token-major, "tbl" int32, bf16-cache "k"/"v" as
    they are."""
    dev = resolve_device(device)
    out = {}
    for key, val in cache_numpy.items():
        if key == "tbl":
            out[key] = torch.tensor(np.asarray(val, np.int32), device=dev)
            continue
        layers = [np.asarray(v) for v in val]
        if key in _PACKED:
            layers = [np.swapaxes(a, -1, -2) for a in layers]
        out[key] = [_to_torch(np.ascontiguousarray(a), dev) for a in layers]
    return out


def to_jax_cache(cache: dict) -> dict:
    """Inverse of from_jax_cache: the port's cache -> numpy arrays in the
    JAX package's layout, stacked over layers (bf16 values widened to
    float32, exactly)."""
    out = {}
    for key, val in cache.items():
        if key == "tbl":
            out[key] = val.cpu().numpy()
            continue
        layers = [t.cpu() for t in val]
        layers = [(t.float() if t.dtype == torch.bfloat16 else t).numpy()
                  for t in layers]
        if key in _PACKED:
            layers = [np.swapaxes(a, -1, -2) for a in layers]
        out[key] = np.stack(layers)
    return out
