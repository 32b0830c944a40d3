"""Checkpoint and artifact persistence (port of
flatquant_tpu/utils/checkpoint.py), in the JAX package's formats so each
package reads what the other writes:

  1. flat_parameters: the raw trainable FQ state (the resume artifact,
     flat_utils.py:52-62), flax msgpack;
  2. flat_matrices: the frozen FQ state (flat_utils.py:65-93), flax
     msgpack;
  3. packed int4 safetensors with a quantization_config and a dtype
     manifest (flat_utils.py:97-204), one file or HF-style shards plus an
     index.

Trees map onto JAX's pytrees so: a dataclass is a map of its fields in
field order (a field in utils/tree.py META is left out, as flax leaves
out a struct's static fields); a dict keeps its keys; a tuple becomes
the map {'0': ..., '1': ...}; a LIST is the port's per-layer form of a
JAX stack, so its entries are stacked on a new leading axis (and split
again on load). None is msgpack nil. An array is flax's ExtType(1,
packb([shape, dtype name, bytes])), bfloat16 named "bfloat16"; flax cuts
leaves over 2^30 bytes into chunks, which this module neither writes nor
reads (it raises). In safetensors, bf16 tensors are stored as uint16
with a "dtypes" manifest; tensor names join the tree path with "/", dict
keys sorted and None left out, as jax.tree_util flattens.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from flatquant_torch.utils import msgpack_io
from flatquant_torch.utils.safetensors_io import (
    read_safetensors,
    write_safetensors,
)
from flatquant_torch.utils.tree import data_fields, is_dataclass_obj

MAX_CHUNK_BYTES = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.uint16: "uint16", torch.int32: "int32", torch.int64: "int64",
          torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def _stack(items):
    """Per-layer trees of identical structure -> one tree of stacked
    CPU tensors."""
    first = items[0]
    if first is None:
        return None
    if is_dataclass_obj(first):
        return {n: _stack([getattr(t, n) for t in items])
                for n in data_fields(first)}
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in items]) for k in first}
    if isinstance(first, tuple):
        return {str(i): _stack([t[i] for t in items])
                for i in range(len(first))}
    if isinstance(first, list):
        raise ValueError("nested per-layer lists are not a JAX layout")
    return torch.stack([torch.as_tensor(t).detach().cpu() for t in items])


def to_state_dict(tree):
    """The port's tree -> flax's state dict (nested dicts of CPU tensors
    and None)."""
    if tree is None:
        return None
    if isinstance(tree, list):
        return _stack(tree)
    if is_dataclass_obj(tree):
        return {n: to_state_dict(getattr(tree, n)) for n in data_fields(tree)}
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return torch.as_tensor(tree).detach().cpu()


def _leaf(template, stored, index):
    t = stored if index is None else stored[index]
    dev = template.device if torch.is_tensor(template) else "cpu"
    return t.clone().to(dev)


def from_state_dict(template, state, index=None):
    """Rebuild `template`'s structure from a state dict (stacked leaves
    split again where the template has a per-layer list); leaves keep the
    stored dtype and go to the template leaf's device."""
    if template is None:
        return None
    if isinstance(template, list):
        if index is not None:
            raise ValueError("nested per-layer lists are not a JAX layout")
        n = _leading(state)
        if n != len(template):
            raise ValueError(f"checkpoint stacks {n} entries, template "
                             f"holds {len(template)}")
        return [from_state_dict(t, state, i) for i, t in enumerate(template)]
    if is_dataclass_obj(template):
        return dataclasses.replace(template, **{
            n: from_state_dict(getattr(template, n), _get(state, n), index)
            for n in data_fields(template)})
    if isinstance(template, dict):
        return {k: from_state_dict(v, _get(state, str(k)), index)
                for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(from_state_dict(v, _get(state, str(i)), index)
                     for i, v in enumerate(template))
    if state is None or isinstance(state, dict):
        raise ValueError("checkpoint has no array where the template has "
                         "one")
    return _leaf(template, state, index)


def _get(state, key):
    """state[key]; a key left out (a None field in safetensors) -> None."""
    if not isinstance(state, dict):
        raise KeyError(f"checkpoint has no map holding {key!r}")
    return state.get(key)


def _leading(state):
    if isinstance(state, dict):
        for v in state.values():
            n = _leading(v)
            if n is not None:
                return n
        return None
    return None if state is None else state.shape[0]


# --- msgpack ----------------------------------------------------------------


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _encode(sd):
    if isinstance(sd, dict):
        return {k: _encode(v) for k, v in sd.items()}
    if sd is None:
        return None
    nbytes = sd.numel() * sd.element_size()
    if nbytes > MAX_CHUNK_BYTES:
        raise ValueError(f"a {nbytes}-byte leaf is past flax's chunk size; "
                         "chunked leaves are not supported")
    inner = msgpack_io.packb([list(sd.shape), _NAMES[sd.dtype],
                              _tensor_bytes(sd)])
    return msgpack_io.ExtType(1, inner)


def _decode(obj):
    if isinstance(obj, dict):
        if "__msgpack_chunked_array__" in obj:
            raise ValueError("flax chunked array (a leaf over 2^30 bytes): "
                             "not supported")
        return {k: _decode(v) for k, v in obj.items()}
    if obj is None:
        return None
    if not isinstance(obj, msgpack_io.ExtType) or obj.code not in (1, 3):
        raise ValueError(f"unsupported msgpack leaf {obj!r:.80}")
    shape, name, buf = msgpack_io.unpackb(obj.data)
    name = name.decode() if isinstance(name, bytes) else name
    dt = _DTYPES[name]
    np_dt = np.int16 if dt == torch.bfloat16 else np.dtype(name)
    a = np.frombuffer(buf, dtype=np_dt).reshape(shape).copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dt == torch.bfloat16 else t


def to_bytes(tree) -> bytes:
    """flax.serialization.to_bytes of the JAX form of `tree`."""
    return msgpack_io.packb(_encode(to_state_dict(tree)))


def from_bytes(template, data: bytes):
    return from_state_dict(template, _decode(msgpack_io.unpackb(data)))


def save_pytree(path: str, tree) -> None:
    """msgpack-serialize a tree (structure comes from a template at load)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def load_pytree(path: str, template):
    """Load into the structure of `template`."""
    with open(path, "rb") as f:
        return from_bytes(template, f.read())


# --- named aliases for the artifact kinds ------------------------------------


def save_flat_parameters(exp_dir: str, fq_state) -> str:
    path = os.path.join(exp_dir, "flat_parameters.msgpack")
    save_pytree(path, fq_state)
    return path


def load_flat_parameters(exp_dir: str, template):
    return load_pytree(os.path.join(exp_dir, "flat_parameters.msgpack"),
                       template)


def save_flat_matrices(exp_dir: str, baked_fq) -> str:
    path = os.path.join(exp_dir, "flat_matrices.msgpack")
    save_pytree(path, baked_fq)
    return path


def load_flat_matrices(exp_dir: str, template):
    return load_pytree(os.path.join(exp_dir, "flat_matrices.msgpack"),
                       template)


# --- packed int4 safetensors export ------------------------------------------


def flatten_with_keys(tree) -> dict:
    """{"a/b/0": CPU tensor}: the JAX form's leaves under jax.tree_util's
    path names (dict keys sorted, None left out)."""
    out = {}

    def walk(sd, prefix):
        if sd is None:
            return
        if isinstance(sd, dict):
            for k in sorted(sd):
                walk(sd[k], prefix + [k])
        else:
            out["/".join(prefix)] = sd

    walk(to_state_dict(tree), [])
    return out


def _export_meta(quantization_config, manifest):
    return {"format": "flatquant_tpu_packed_int4",
            "dtypes": json.dumps(manifest),
            "quantization_config": json.dumps(quantization_config or {})}


def _storable(tensors):
    """bf16 tensors as their uint16 bits, and the dtype manifest."""
    manifest, out = {}, {}
    for k, v in tensors.items():
        manifest[k] = _NAMES[v.dtype]
        out[k] = (v.contiguous().view(torch.int16).numpy().view(np.uint16)
                  if v.dtype == torch.bfloat16 else v)
    return out, manifest


def save_packed_safetensors(exp_dir: str, serving_params: dict,
                            quantization_config: Optional[dict] = None,
                            filename: str = "model_packed_int4.safetensors"
                            ) -> str:
    """Serving params (packed int4, scales, transforms) -> one safetensors
    file with the quantization_config metadata."""
    os.makedirs(exp_dir, exist_ok=True)
    out, manifest = _storable(flatten_with_keys(serving_params))
    path = os.path.join(exp_dir, filename)
    write_safetensors(path, out, _export_meta(quantization_config, manifest))
    return path


def _restore(raw: dict, manifest: dict, template):
    for k, dt in manifest.items():
        if dt == "bfloat16" and k in raw:
            raw[k] = raw[k].view(torch.bfloat16)
    flat = flatten_with_keys(template)
    state: dict = {}
    for key in flat:
        if key not in raw:
            raise KeyError(f"checkpoint missing tensor {key!r}")
        node = state
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = raw[key]
    return from_state_dict(template, state)


def load_packed_safetensors(path: str, template: dict) -> dict:
    """A packed export back into the structure of `template`."""
    raw, meta = read_safetensors(path)
    return _restore(raw, json.loads(meta.get("dtypes", "{}")), template)


def save_packed_safetensors_sharded(
        exp_dir: str, serving_params: dict,
        quantization_config: Optional[dict] = None,
        max_shard_bytes: int = 5 * 1024**3,
        basename: str = "model_packed_int4") -> str:
    """Sharded packed export: `<basename>-00001-of-0000N.safetensors` plus
    a `<basename>.safetensors.index.json` weight map (the HF shard
    convention of the reference's exporter, flat_utils.py:97-204). A
    model that fits one shard gets the one-file layout. Returns the index
    (or single-file) path."""
    os.makedirs(exp_dir, exist_ok=True)
    tensors = flatten_with_keys(serving_params)
    sizes = {k: v.numel() * v.element_size() for k, v in tensors.items()}
    total = sum(sizes.values())
    if total <= max_shard_bytes:
        return save_packed_safetensors(exp_dir, serving_params,
                                       quantization_config,
                                       filename=f"{basename}.safetensors")
    shards, filled = [[]], [0]
    for k in tensors:  # greedy fill in key order
        if filled[-1] + sizes[k] > max_shard_bytes and shards[-1]:
            shards.append([])
            filled.append(0)
        shards[-1].append(k)
        filled[-1] += sizes[k]
    out, manifest = _storable(tensors)
    meta = _export_meta(quantization_config, manifest)
    n = len(shards)
    weight_map = {}
    for i, keys in enumerate(shards):
        fname = f"{basename}-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(os.path.join(exp_dir, fname),
                          {k: out[k] for k in keys}, meta)
        weight_map.update(dict.fromkeys(keys, fname))
    index_path = os.path.join(exp_dir, f"{basename}.safetensors.index.json")
    with open(index_path, "w") as fh:
        json.dump({"metadata": {"total_size": total, **meta},
                   "weight_map": weight_map}, fh, indent=1)
    return index_path


def load_packed_safetensors_sharded(path: str, template: dict) -> dict:
    """A sharded packed export (index.json path), or a single-file one."""
    if not path.endswith(".index.json"):
        return load_packed_safetensors(path, template)
    with open(path) as fh:
        index = json.load(fh)
    base = os.path.dirname(os.path.abspath(path))
    raw = {}
    for fname in sorted(set(index["weight_map"].values())):
        raw.update(read_safetensors(os.path.join(base, fname))[0])
    return _restore(raw, json.loads(index["metadata"].get("dtypes", "{}")),
                    template)
