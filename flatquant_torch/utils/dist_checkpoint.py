"""Topology-free sharded checkpoints (port of
flatquant_tpu/utils/dist_checkpoint.py).

A checkpoint written under one mesh loads under any other, or in one
process, without an offline reshard: the reference's per-rank
`model{rank}-mp{ws}.safetensors` and `flat_matrices_{rank}.pth` files
cannot do that (main_dpskv3.py:416,446). JAX writes it with orbax, each
host its own shards. The port writes a plain format of its own:

  path/shard-RRRRR.safetensors  the blocks rank R owns, written with the
                                port's utils/safetensors_io.py
  path/shard-RRRRR.json         their index: for each leaf (by its path
                                in the tree) the global shape, the split
                                dim (or null) and the block's [start,
                                stop) on it

Every rank writes only its own blocks, and of the ranks holding the same
block (replicas over the other axes) only the one at index 0 on every
other axis writes it; no rank gathers the tree. A load reads the indexes
of every rank and copies, for each leaf, the parts of the stored blocks
that fall in the block this rank needs under the target mesh and specs
(or the whole leaf without a mesh), bytes as stored. Why not
torch.distributed.checkpoint: its on-disk layout follows the torch
release that wrote it (the card's machine and this repo's CPU tests run
different ones), and it wants DTensors on a DeviceMesh where the port
keeps plain tensors and parallel/mesh.py specs. Orbax directories of the
JAX package are not read (the card's machine has no orbax).

Specs are parallel/mesh.py's: None (replicated) or (axis name, dim).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from flatquant_torch.parallel.mesh import spec_axis
from flatquant_torch.utils.safetensors_io import (
    _TAGS,
    read_header,
    write_safetensors,
)
from flatquant_torch.utils.tree import data_fields, is_dataclass_obj


def _walk(tree, specs, prefix, out):
    """(path, leaf, spec) of every tensor leaf; a None spec covers its
    whole subtree."""
    if tree is None:
        return
    if is_dataclass_obj(tree):
        for n in data_fields(tree):
            _walk(getattr(tree, n), None if specs is None
                  else getattr(specs, n), prefix + (n,), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, None if specs is None else specs[k], prefix + (str(k),),
                  out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, None if specs is None else specs[i],
                  prefix + (str(i),), out)
    elif torch.is_tensor(tree):
        out.append((".".join(prefix), tree, specs))


def _map(tree, specs, prefix, fn):
    """tree with every tensor leaf replaced by fn(path, leaf, spec)."""
    import dataclasses

    if tree is None:
        return None
    if is_dataclass_obj(tree):
        return dataclasses.replace(tree, **{
            n: _map(getattr(tree, n), None if specs is None
                    else getattr(specs, n), prefix + (n,), fn)
            for n in data_fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(v, None if specs is None else specs[k],
                        prefix + (str(k),), fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, None if specs is None else specs[i],
                               prefix + (str(i),), fn)
                          for i, v in enumerate(tree))
    if torch.is_tensor(tree) or hasattr(tree, "shape"):
        return fn(".".join(prefix), tree, specs)
    return tree


def _owner(mesh, axis_name: Optional[str]) -> bool:
    """Whether this rank writes a block split over axis_name (None:
    replicated): it sits at index 0 on every other axis."""
    return all(mesh.axis(n).index == 0 for n in mesh.axis_names
               if n != axis_name and mesh.shape[n] > 1)


def save_sharded(path: str, tree, mesh=None, specs=None) -> str:
    """Write this rank's part of a tree of tensors (dataclasses, dicts,
    lists; None leaves skipped). mesh / specs: how the leaves were cut
    (parallel/mesh.py shard_tree); without them the tree is whole and
    this process writes all of it. Every rank of the mesh must call it;
    it returns once every rank has written."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    rank = 0 if mesh is None else mesh.rank
    together = mesh is not None and dist.is_initialized()
    # an earlier checkpoint in the directory, from any world size, goes
    if together:
        dist.barrier()
    if rank == 0:
        for old in glob.glob(os.path.join(path, "shard-*")):
            os.remove(old)
    if together:
        dist.barrier()
    leaves = []
    _walk(tree, specs, (), leaves)
    tensors, index = {}, {}
    for key, t, spec in leaves:
        cut = None if mesh is None else spec_axis(spec, mesh)
        if mesh is not None and not _owner(
                mesh, None if cut is None else cut[0].name):
            continue
        shape = list(t.shape)
        entry = dict(dim=None)
        if cut is not None:
            axis, dim = cut
            n = shape[dim]
            shape[dim] = n * axis.size
            entry.update(dim=dim, start=axis.index * n,
                         stop=(axis.index + 1) * n)
        entry["shape"] = shape
        tensors[key] = t.detach().cpu().contiguous()
        index[key] = entry
    if index:  # a rank that owns no block writes nothing
        stem = os.path.join(path, f"shard-{rank:05d}")
        write_safetensors(stem + ".safetensors", tensors)
        with open(stem + ".json", "w") as f:
            json.dump(index, f)
    if together:
        dist.barrier()
    return path


class _Blocks:
    """Every rank's index, and each file's tensors read on demand."""

    def __init__(self, path):
        self.blocks = {}
        self.files = {}
        for idx in sorted(glob.glob(os.path.join(path, "shard-*.json"))):
            st = idx[:-len(".json")] + ".safetensors"
            with open(idx) as f:
                for key, e in json.load(f).items():
                    self.blocks.setdefault(key, []).append((st, e))
        if not self.blocks:
            raise FileNotFoundError(f"no sharded checkpoint under {path}")

    def tensor(self, file, key):
        if file not in self.files:
            entries, _, base = read_header(file)
            self.files[file] = (entries, base,
                                np.memmap(file, dtype=np.uint8, mode="r"))
        entries, base, raw = self.files[file]
        e = entries[key]
        np_dt, t_dt = _TAGS[e["dtype"]]
        lo, hi = e["data_offsets"]
        a = np.array(raw[base + lo:base + hi]).view(np_dt).reshape(e["shape"])
        t = torch.from_numpy(a)
        return t.view(t_dt) if t.dtype != t_dt else t


def load_sharded(path: str, template, mesh=None, specs=None, device=None):
    """Restore a tree written by save_sharded. template: the tree of
    whole leaves (tensors, or anything with .shape) giving its structure;
    the stored global shapes must equal theirs. With mesh / specs each
    leaf comes back as this rank's block of it (parallel/mesh.py
    shard_tree's cut), whatever mesh wrote it; without them, whole.
    Leaves go to `device` (default: the template leaf's, or the CPU)."""
    store = _Blocks(os.path.abspath(path))

    def load(key, leaf, spec):
        if key not in store.blocks:
            raise KeyError(f"{key} is not in the checkpoint at {path}")
        parts = store.blocks[key]
        shape = parts[0][1]["shape"]
        if list(leaf.shape) != shape:
            raise ValueError(f"{key}: stored shape {shape}, template "
                             f"{list(leaf.shape)}")
        lo, hi = [0] * len(shape), list(shape)
        cut = None if mesh is None else spec_axis(spec, mesh)
        if cut is not None:
            axis, dim = cut
            blk = axis.block(shape[dim])
            lo[dim], hi[dim] = blk.start, blk.stop
        out, covered = None, 0
        for file, e in parts:
            src_lo, src_hi = [0] * len(shape), list(shape)
            if e["dim"] is not None:
                src_lo[e["dim"]], src_hi[e["dim"]] = e["start"], e["stop"]
            a = [max(x, y) for x, y in zip(lo, src_lo)]
            b = [min(x, y) for x, y in zip(hi, src_hi)]
            if any(x >= y for x, y in zip(a, b)):
                continue
            t = store.tensor(file, key)
            if out is None:
                out = torch.empty([y - x for x, y in zip(lo, hi)],
                                  dtype=t.dtype)
            out[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, lo))] = \
                t[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, src_lo))]
            covered += int(np.prod([y - x for x, y in zip(a, b)]))
        if out is None or covered != out.numel():
            raise ValueError(f"{key}: the stored blocks do not cover this "
                             "rank's")
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        return out.to(dev)

    return _map(template, specs, (), load)
