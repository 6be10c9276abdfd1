"""Sharding-plan builders for the launchers (port of
``repro.launch.shardings``, DESIGN.md §5).

Each builder returns a tree of :class:`~repro_torch.distributed.sharding.P`
specs in its input's own structure (leaves need only ``.shape`` and
``.ndim``: tensors, meta tensors or DTensors), for a ``DeviceMesh`` or an
:class:`~repro_torch.distributed.sharding.AbstractMesh`; :func:`place`
lays a tree of full tensors out by one (``sharding.to_placements`` gives
a spec's DTensor placements) and :func:`named` makes it a tree of
``NamedSharding``.  A spec never
shards a dim the mesh axes do not divide (the reference's jit
``in_shardings`` require that), so every shard is the same size.
"""
from __future__ import annotations

from typing import Dict

from ..distributed.sharding import (NamedSharding, P, axis_names,
                                    axis_size, distribute, mesh_shape,
                                    param_partition_specs)
from ..models.config import ArchConfig
from ..tree import tree_map, tree_map_with_path


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _dp_entry(mesh):
    dp = _dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def drop_indivisible(specs, shapes, mesh):
    """Drop mesh axes from dims whose size they don't divide — e.g.
    hymba's vocab 32001 can't shard 16-way; the embedding then replicates
    over model and FSDP picks the d_model dim instead."""

    def one(spec, leaf):
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, ax in enumerate(dims):
            if ax is None:
                continue
            if leaf.shape[i] % axis_size(mesh, ax) != 0:
                dims[i] = None
        return P(*dims)

    return tree_map(one, specs, shapes)


def fsdp_extend(specs, shapes, mesh, axes=None):
    """Add a data-parallel shard dim to each leaf spec (ZeRO/FSDP-style):
    pick the largest dim that is unsharded and divisible by the dp size."""
    axes = axes or _dp_axes(mesh)
    dp = axis_size(mesh, axes)

    def one(spec, leaf):
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        best, best_size = None, 0
        for i, (d, s) in enumerate(zip(dims, leaf.shape)):
            if d is None and s % dp == 0 and s > best_size:
                best, best_size = i, s
        if best is None or best_size < dp:
            return P(*dims)
        dims[best] = axes if len(axes) > 1 else axes[0]
        return P(*dims)

    return tree_map(one, specs, shapes)


def state_shardings(state_shape, mesh, fsdp: bool = True):
    """TP (by param name) + optional FSDP extension: a spec tree."""
    specs = param_partition_specs(state_shape, mesh)
    specs = drop_indivisible(specs, state_shape, mesh)
    if fsdp:
        specs = fsdp_extend(specs, state_shape, mesh)
    return specs


def params_shardings(params_shape, mesh, fsdp: bool = False):
    return state_shardings(params_shape, mesh, fsdp=fsdp)


def batch_shardings(batch_spec: Dict, mesh):
    """Batch leaves over the data-parallel axes: ``positions`` (3, B, S) on
    dim 1, tokens/labels (B, S) and embeds (B, S, D) on dim 0."""
    dp_ax = _dp_entry(mesh)

    def one(name, leaf):
        if name == "positions":            # (3, B, S)
            return P(None, dp_ax, None)
        if leaf.ndim == 2:                  # tokens/labels (B, S)
            return P(dp_ax, None)
        if leaf.ndim == 3:                  # embeds (B, S, D)
            return P(dp_ax, None, None)
        return P()

    return {k: one(k, v) for k, v in batch_spec.items()}


def cache_shardings(caches_shape, cfg: ArchConfig, mesh,
                    long_ctx: bool = False):
    """Decode-cache specs.  Leaves are layer-stacked: (L, B, S, H, ...) for
    KV segments, (L, B, ...) for SSM/RWKV states and per-slot lengths.

    Default: batch over (pod, data), kv-heads over model when divisible
    (KV replication otherwise).  long_ctx (batch=1): context parallelism —
    the sequence dim shards over (pod, data)."""
    dp_ax = _dp_entry(mesh)
    tp = mesh_shape(mesh).get("model", 1)

    def one(path, leaf):
        name = path[-1]
        if leaf.ndim <= 1:
            return P()
        dims = [None] * leaf.ndim
        is_kv_seg = any(name.startswith(p) for p in
                        ("qk_", "qv_", "win_", "sink_", "x_qk", "x_qv",
                         "x_win", "x_sink", "k", "v"))
        is_packed = name.startswith(("qk_", "qv_", "x_qk", "x_qv"))
        if is_kv_seg and leaf.ndim >= 4:
            # (L, B, S, H, ...)
            if long_ctx:
                if is_packed:  # context parallelism over the packed region
                    dims[2] = dp_ax
            else:
                dims[1] = dp_ax
            if leaf.shape[3] % tp == 0 and leaf.shape[3] >= tp:
                dims[3] = "model"
        elif leaf.ndim >= 2:
            # state tensors (L, B, ...): batch over dp, widest dim over model
            if not long_ctx and leaf.shape[1] % axis_size(mesh, dp_ax) == 0:
                dims[1] = dp_ax
            for i in range(leaf.ndim - 1, 1, -1):
                if leaf.shape[i] % tp == 0 and leaf.shape[i] >= tp:
                    dims[i] = "model"
                    break
        # every shard the same size
        for i, ax in enumerate(dims):
            if ax is not None and leaf.shape[i] % axis_size(mesh, ax) != 0:
                dims[i] = None
        return P(*dims)

    return tree_map_with_path(one, caches_shape)


def token_sharding(token_spec, mesh):
    dims = [_dp_entry(mesh)] + [None] * (token_spec.ndim - 1)
    if token_spec.shape[0] == 1:  # long-context batch=1: replicate
        dims[0] = None
    return P(*dims)


def named(specs, mesh):
    """A spec tree as a tree of ``NamedSharding`` on ``mesh`` (what
    ``checkpoint.load_latest(shardings=)`` takes)."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def place(tree, specs, mesh):
    """A tree of full tensors (equal on every rank) as DTensors laid out
    by ``specs``: each rank keeps its own shards, nothing crosses ranks."""
    return tree_map(lambda x, s: distribute(x, s, mesh), tree, specs)
