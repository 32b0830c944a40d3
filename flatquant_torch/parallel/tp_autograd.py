"""Collectives with a stated backward, for training under a mesh (the
calibration half of flatquant_tpu/parallel/mesh.py's GSPMD programs).

JAX differentiates one SPMD program and GSPMD places the collectives of
both passes. The port runs one program per rank and writes them out,
Megatron style, so each tensor crossing between replicated and sharded
compute passes through one of these autograd Functions:

  copy_to(x)           forward identity, backward all-reduce (sum): a
                       replicated tensor (or FQ leaf) entering compute on
                       this rank's block, whose gradient is then partial;
  reduce_from(x)       forward all-reduce (sum), backward identity: the
                       partial sums of a row-parallel product;
  gather_from(x, dim)  forward all-gather, backward keep this rank's
                       block: a sharded tensor entering replicated compute;
  scatter_to(x, dim)   forward keep this rank's block, backward
                       all-gather: a replicated tensor cut into blocks,
                       each used by its own rank alone;
  shard_max / shard_min(x, dim)
                       the extremum along a dim split over the axis; the
                       result is used by every rank on its own block, so
                       the backward sums the ranks' gradients and hands
                       them to the tied extrema in equal shares, as amax
                       shares them (core/quant.py).
  row_reducer(axis)    core/quant.py's `row_reduce` hook for a row split
                       over the axis (a row-parallel linear's input and
                       weight): max / min by shard_max / shard_min, sum
                       by reduce_from.

The invariant they keep: the gradient of every replicated tensor is
whole and equal on every rank of the axis. Each takes an `Axis`
(parallel/mesh.py) or None; None or a size-1 axis is the identity.
"""

from __future__ import annotations

import torch

from flatquant_torch.parallel.distributed import all_gather, all_reduce
from flatquant_torch.utils.tree import tree_map


def active(axis) -> bool:
    """Whether `axis` splits anything (not None, size > 1)."""
    return axis is not None and axis.size > 1


def _block(x, dim, axis):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axis), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        if x.shape[dim] % axis.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis.name}={axis.size}")
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


class _ShardMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        m = all_reduce(x.amax(dim=dim, keepdim=True), "max", axis)
        ties = x == m
        count = all_reduce(ties.sum(dim=dim, keepdim=True, dtype=torch.int32),
                           "sum", axis)
        ctx.save_for_backward(ties, count)
        ctx.axis = axis
        return m

    @staticmethod
    def backward(ctx, g):
        ties, count = ctx.saved_tensors
        g = all_reduce(g.contiguous(), "sum", ctx.axis)
        return ties.to(g.dtype) * (g / count.to(g.dtype)), None, None


def copy_to(x, axis):
    return _CopyTo.apply(x, axis) if active(axis) else x


def reduce_from(x, axis):
    return _ReduceFrom.apply(x, axis) if active(axis) else x


def gather_from(x, dim: int, axis):
    return _GatherFrom.apply(x, dim % x.dim(), axis) if active(axis) else x


def scatter_to(x, dim: int, axis):
    return _ScatterTo.apply(x, dim % x.dim(), axis) if active(axis) else x


def shard_max(x, dim: int, axis):
    """max of x along `dim` (kept, size 1) over every rank's block of it."""
    if not active(axis):
        return x.amax(dim=dim, keepdim=True)
    return _ShardMax.apply(x, dim % x.dim(), axis)


def shard_min(x, dim: int, axis):
    """min of x along `dim` (kept, size 1) over every rank's block of it."""
    if not active(axis):
        return x.amin(dim=dim, keepdim=True)
    return -_ShardMax.apply(-x, dim % x.dim(), axis)


def row_reducer(axis):
    """core/quant.py's `row_reduce` hook for rows whose reduced dim is
    split over `axis` (None when it splits nothing): the quantizers of a
    row-parallel linear then take the whole row's extrema (and the weight
    MSE search its whole error) on every rank."""
    if not active(axis):
        return None

    def reduce(t, dim: int, op: str):
        if op == "max":
            return shard_max(t, dim, axis)
        if op == "min":
            return shard_min(t, dim, axis)
        return reduce_from(t.sum(dim=dim, keepdim=True), axis)

    return reduce


def copy_tree(tree, axis):
    """copy_to over every tensor leaf of a tree (an FQ transform or a
    linear's state): replicated leaves entering this rank's block."""
    if not active(axis):
        return tree
    return tree_map(lambda t: copy_to(t, axis) if torch.is_tensor(t) else t,
                    tree)
