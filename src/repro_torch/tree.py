"""Nested-dict trees of tensors (the port's params, optimizer and train
states), walked in the order ``jax.tree.flatten`` walks the reference's
dicts: keys sorted at every level.  The optimizer's global norm sums its
leaves in this order, and a checkpoint's leaf files are numbered by it, so
that either package reads the other's checkpoints."""
from __future__ import annotations

from typing import Callable, List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The leaves, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, flat) -> object:
    """``like``'s structure with ``flat`` (in :func:`leaves` order) as its
    leaves."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, _path=()):
    """:func:`tree_map` with ``fn(path, leaf, *rest_leaves)``: ``path``
    the tuple of keys from the root down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      _path=_path + (k,))
                for k in sorted(tree)}
    return fn(_path, tree, *rest)


def structure(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it for a
    dict tree: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
