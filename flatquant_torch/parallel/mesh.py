"""The device mesh: named axes over torch.distributed ranks (port of
flatquant_tpu/parallel/mesh.py).

JAX's Mesh names the axes of a device array and shard_map hands every
device its block; collectives then name an axis. Here one process runs per
rank, so the mesh maps each axis name ("dp", "tp", "pp", "sp", "ep") to
this rank's process group along it, with its index and size on that axis
(`Axis`), and the collectives of parallel/distributed.py take that axis.
Ranks are laid out in row-major order over the axes' sizes, as
`np.asarray(devices).reshape(sizes)` lays out JAX's devices.

`deepseek_serving_specs` is the rule that hands each "ep" rank its block
of DeepSeek's routed experts (`shard_ds_serving_params` applies it). The
fp models' specs for calibration (`llama_param_specs`,
`deepseek_param_specs`) wait for ROADMAP queue 1 item 9's slice 20.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Axis:
    """One mesh axis as this rank sees it: its name, size, this rank's
    index along it, the global ranks of its group in index order, and the
    process group (None for a size-1 axis)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None
    backend: str = "gloo"

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n items split over the axis."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.name}="
                             f"{self.size}")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


class Mesh:
    """Named axes over the world's ranks (row-major). `shape[name]` is an
    axis's size, `axis(name)` its `Axis`, `device` this rank's device."""

    def __init__(self, axes: Dict[str, int], axis_objs: Dict[str, Axis],
                 device, rank: int):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self._axes = axis_objs
        self.device = torch.device(device)
        self.rank = rank

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise KeyError(f"mesh axes {self.axis_names} have no {name!r}")
        return self._axes[name]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _grid(axes: Dict[str, int]) -> np.ndarray:
    """The global ranks laid out row-major over the axes' sizes."""
    sizes = tuple(int(s) for s in axes.values())
    return np.arange(int(np.prod(sizes))).reshape(sizes)


def plan_mesh(axes: Dict[str, int], rank: int, device="cuda") -> Mesh:
    """The mesh rank `rank` will see, without process groups: for cutting
    a rank's shard on the host before the ranks start (a caller that
    builds a model once and hands each rank its slice). Collectives over
    its axes are not possible."""
    grid = _grid(axes)
    coord = np.unravel_index(rank, grid.shape)
    objs = {}
    for ai, name in enumerate(axes):
        line = np.moveaxis(grid, ai, -1)[tuple(
            c for j, c in enumerate(coord) if j != ai)]
        objs[name] = Axis(name, grid.shape[ai], int(coord[ai]),
                          tuple(int(r) for r in line))
    return Mesh(axes, objs, device, rank)


def make_mesh(axes: Dict[str, int], device="cuda") -> Mesh:
    """Mesh from {axis: size}; the sizes must multiply to the world size
    (1 without a process group): plan_mesh's layout for this rank, with
    the process group of each of its axes. Every rank must call it, with
    the same axes: it creates one process group per line of every axis,
    all ranks taking part in every creation, as torch.distributed
    requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = _grid(axes)
    if grid.size != world:
        raise ValueError(f"mesh {axes} needs {grid.size} ranks, the world "
                         f"has {world}")
    mesh = plan_mesh(axes, rank, device)
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    for ai, name in enumerate(mesh.axis_names):
        axis = mesh.axis(name)
        axis.backend = backend
        if axis.size == 1:
            continue
        for line in np.moveaxis(grid, ai, -1).reshape(-1, axis.size):
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if ranks == axis.ranks:
                axis.group = group
    return mesh


def deepseek_serving_specs(sp: dict, ep_axis: str = "ep") -> dict:
    """Which dim of each DeepSeek serving leaf shards over `ep_axis` (None:
    replicated), as JAX's PartitionSpec tree: every tensor of the routed
    experts e_w1 / e_w2 / e_w3 splits on its leading expert dim (packed
    W4A4 "wp" [E, N, K/2] and "scale" [E, N]; FP8 codes and block
    scales; an unpacked [E, N, K] stack), the shared activation clips
    excepted; everything else replicates. The MoE weights dominate
    DeepSeek's bytes, so ep is the axis packed serving needs first."""
    experts = ("e_w1", "e_w2", "e_w3")

    def rule(tree, path):
        if isinstance(tree, dict):
            return {k: rule(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rule(v, path) for v in tree)
        if ("moe_layers" in path and any(e in path for e in experts)
                and "a_clip" not in path and torch.is_tensor(tree)):
            return 0
        return None

    return rule(sp, ())


def shard_tree(tree, specs, axis: Axis):
    """This rank's part of `tree`: each leaf with an int spec is cut along
    that dim into axis.size blocks and this rank's block copied out (so
    the full tree can be freed); leaves with spec None are kept as they
    are."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, axis)
                          for v, s in zip(tree, specs))
    if specs is None or not torch.is_tensor(tree):
        return tree
    idx = [slice(None)] * tree.dim()
    idx[specs] = axis.block(tree.shape[specs])
    return tree[tuple(idx)].clone()


def shard_ds_serving_params(spfq: dict, mesh: Mesh,
                            ep_axis: str = "ep") -> dict:
    """The batcher's DeepSeek bundle {"params", "fq"} with the routed
    experts split over `ep_axis` (this rank's E/ep experts) and the axis
    recorded under "ep", which `ds_batch_forward` reads: each rank runs
    its experts for every token and the partial sums are all-reduced over
    the axis. Attention, the gate and the shared experts replicate."""
    axis = mesh.axis(ep_axis)
    sp = spfq["params"]
    out = dict(spfq)
    out["params"] = shard_tree(sp, deepseek_serving_specs(sp, ep_axis), axis)
    out["ep"] = axis
    return out


def llama_param_specs(*args, **kwargs):
    """JAX's tp / dp specs of the fp Llama params (calibration under a
    mesh): not ported yet."""
    raise NotImplementedError(
        "llama_param_specs (calibration under a mesh) waits for ROADMAP "
        "queue 1 item 9, slice 20")


def deepseek_param_specs(*args, **kwargs):
    """JAX's tp / ep specs of the fp DeepSeek params (calibration under a
    mesh): not ported yet."""
    raise NotImplementedError(
        "deepseek_param_specs (calibration under a mesh) waits for ROADMAP "
        "queue 1 item 9, slice 20")
