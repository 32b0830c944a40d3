"""Tree helpers over the port's state containers: dataclasses (the
FlatQuant state), dicts, lists and tuples, with tensors (or labels) at
the leaves and None for an absent part. A dataclass field named in META
(BakedDecompose.perm, a layout flag) is carried, not mapped: JAX keeps it
out of the pytree the same way."""

from __future__ import annotations

import dataclasses

META = frozenset({"perm"})


def is_dataclass_obj(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def data_fields(tree):
    """A dataclass instance's field names, in order, but META's."""
    return [f.name for f in dataclasses.fields(tree) if f.name not in META]


def tree_map(fn, tree, *rest):
    """fn over every leaf of `tree` (and the same leaf of each tree in
    `rest`, which share its structure); None stays None."""
    if tree is None:
        return None
    if is_dataclass_obj(tree):
        return dataclasses.replace(tree, **{
            n: tree_map(fn, getattr(tree, n), *[getattr(r, n) for r in rest])
            for n in data_fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Every leaf of `tree` in field / insertion / index order."""
    out = []
    tree_map(out.append, tree)
    return out
