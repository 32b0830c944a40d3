"""The device mesh: named axes over torch.distributed ranks (port of
flatquant_tpu/parallel/mesh.py).

JAX's Mesh names the axes of a device array and shard_map hands every
device its block; collectives then name an axis. Here one process runs per
rank, so the mesh maps each axis name ("dp", "tp", "pp", "sp", "ep") to
this rank's process group along it, with its index and size on that axis
(`Axis`), and the collectives of parallel/distributed.py take that axis.
Ranks are laid out in row-major order over the axes' sizes, as
`np.asarray(devices).reshape(sizes)` lays out JAX's devices.

Specs. JAX's PartitionSpec names, for each dim of a leaf, the mesh axis
it splits over. The port's spec of a leaf is None (replicated) or a pair
(axis name, dim): every leaf splits over at most one axis, on one dim,
and the per-layer leaves carry no stacked [L] dim (JAX's dim d + 1 is
the port's d). A spec naming an axis the mesh lacks, or of size 1,
replicates. `llama_param_specs` and `deepseek_param_specs` are JAX's
rules for the fp params of calibration under a mesh; `shard_tree` cuts a
rank's blocks by them, `replicated_specs` and `batch_spec` come along.
`deepseek_serving_specs` is the rule that hands each "ep" rank its block
of DeepSeek's packed routed experts (`shard_ds_serving_params` applies
it), and parallel/serving_tp.py `serving_param_specs` the tp rule of the
packed Llama; their specs are of the same form.
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
    """The spec of each DeepSeek serving leaf ((ep_axis, dim), or None:
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
            return (ep_axis, 0)
        return None

    return rule(sp, ())


def spec_axis(spec, mesh) -> Optional[Tuple[Axis, int]]:
    """(Axis, dim) a spec splits over on `mesh`, or None when it
    replicates there (None, or an axis the mesh lacks or of size 1)."""
    if spec is None:
        return None
    name, dim = spec
    if name not in mesh.shape or mesh.shape[name] == 1:
        return None
    return mesh.axis(name), dim


def shard_tree(tree, specs, mesh):
    """This rank's part of `tree` on `mesh` (make_mesh's or plan_mesh's)
    by a spec tree of (axis name, dim) leaves, each cut leaf copied out
    (so the full tree can be freed); leaves that replicate are kept as
    they are."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    if specs is None or not torch.is_tensor(tree):
        return tree
    cut = spec_axis(specs, mesh)
    if cut is None:
        return tree
    axis, dim = cut
    idx = [slice(None)] * tree.dim()
    idx[dim] = axis.block(tree.shape[dim])
    return tree[tuple(idx)].clone()


def replicated_specs(tree):
    """A spec tree of `tree`'s structure, every leaf replicated."""
    if isinstance(tree, dict):
        return {k: replicated_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated_specs(v) for v in tree)
    return None


def batch_spec():
    """The spec of a batch-major tensor: its leading dim over "dp"."""
    return ("dp", 0)


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """The mesh's Axis `name`, or None when the mesh is None, lacks it or
    has it at size 1 (nothing to split)."""
    if mesh is None or name not in mesh.shape or mesh.shape[name] == 1:
        return None
    return mesh.axis(name)


def shard_ds_serving_params(spfq: dict, mesh: Mesh,
                            ep_axis: str = "ep") -> dict:
    """The batcher's DeepSeek bundle {"params", "fq"} with the routed
    experts split over `ep_axis` (this rank's E/ep experts) and the axis
    recorded under "ep", which `ds_batch_forward` reads: each rank runs
    its experts for every token and the partial sums are all-reduced over
    the axis. Attention, the gate and the shared experts replicate."""
    sp = spfq["params"]
    out = dict(spfq)
    out["params"] = shard_tree(sp, deepseek_serving_specs(sp, ep_axis), mesh)
    out["ep"] = mesh.axis(ep_axis)
    return out


def llama_param_specs(cfg, params: dict, shard_vocab: bool = False,
                      tp_size: Optional[int] = None) -> dict:
    """Specs of the fp Llama params for calibration under a mesh (JAX's
    tree, the port's per-layer list): q / k / v / up / gate column-parallel
    (out features, dim 0, over "tp"), o / down row-parallel (in features,
    dim 1), biases with their weights, a vocab-parallel lm_head, and the
    embedding over "tp" only with shard_vocab (a masked lookup and an
    all-reduce). tp_size (when known) makes the split head-granular: wk /
    wv (and their biases) replicate unless tp divides num_kv_heads, wq /
    wo / bq unless it divides num_heads (the Megatron rule)."""
    kv_ok = tp_size is None or cfg.num_kv_heads % tp_size == 0
    q_ok = tp_size is None or cfg.num_heads % tp_size == 0
    col, row = ("tp", 0), ("tp", 1)

    def layer(lp):
        out = {"ln1_w": None, "ln2_w": None,
               "wq": col if q_ok else None,
               "wk": col if kv_ok else None,
               "wv": col if kv_ok else None,
               "wup": col, "wgate": col,
               "wo": row if q_ok else None,
               "wdown": row}
        for bkey, ok in (("bq", q_ok), ("bk", kv_ok), ("bv", kv_ok)):
            if bkey in lp:
                out[bkey] = ("tp", 0) if ok else None
        return out

    specs = {"embed": ("tp", 0) if shard_vocab else None,
             "final_norm_w": None,
             "layers": [layer(lp) for lp in params["layers"]]}
    if "lm_head" in params:
        specs["lm_head"] = ("tp", 0)  # vocab-parallel head
    return specs


def deepseek_param_specs(cfg, params: dict) -> dict:
    """Specs of the fp DeepSeek params for calibration under a mesh: MLA
    heads over "tp" (wq or wq_b and wkv_b by heads, wo row-parallel), the
    dense FFN and the shared experts Megatron style, the routed experts
    over "ep" by their leading expert dim; the gate, wkv_a, wq_a and the
    norms replicate; a vocab-parallel head."""
    col, row = ("tp", 0), ("tp", 1)

    def attn(lp):
        d = {"attn_norm": None, "ffn_norm": None, "wkv_a": None,
             "kv_norm": None, "wkv_b": col, "wo": row}
        if "wq_a" in lp:
            d.update(wq_a=None, q_norm=None, wq_b=col)
        else:
            d["wq"] = col
        return d

    def dense(lp):
        return dict(attn(lp), w1=col, w2=row, w3=col)

    def moe(lp):
        d = dict(attn(lp), gate_w=None, e_w1=("ep", 0), e_w2=("ep", 0),
                 e_w3=("ep", 0), s_w1=col, s_w2=row, s_w3=col)
        if "gate_b" in lp:
            d["gate_b"] = None
        return d

    return {"embed": None, "final_norm": None, "head": ("tp", 0),
            "dense_layers": [dense(lp) for lp in params["dense_layers"]],
            "moe_layers": [moe(lp) for lp in params["moe_layers"]]}
