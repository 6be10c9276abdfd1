"""Gradient compression for the slow cross-pod link (port of
``repro.distributed.compression``, DESIGN.md §5).  Two pieces,
composable:

* :func:`ef_int8_compress` — error-feedback int8 rounding of the gradient
  tree, the *numerics* of compressed data-parallel sync: quantize
  ``g + e`` to per-tensor int8 and carry the residual ``e`` forward.  It
  takes no mesh (the reference's ``mesh`` argument is unused there too).
* :func:`int8_allreduce_pod` — the *wire* path: each member of a pod group
  quantizes its tensor, the group all-gathers the ``torch.int8`` codes and
  the f32 scales (4x fewer collective bytes than f32, 2x fewer than bf16),
  and every member dequantizes and takes the mean.  The reference runs it
  in a partial ``shard_map`` over ``pod``; the port calls the collectives
  on the process group of the mesh's ``pod`` dim.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_map
from .sharding import axis_names, is_dtensor, layout_mesh, mesh_shape


def _quant_int8(g32: torch.Tensor, amax=None):
    """Per-tensor symmetric int8: (codes, f32 scale = max|g| / 127);
    ``amax`` is max|g| where the caller has it (over a sharded tensor)."""
    if amax is None:
        amax = torch.max(torch.abs(g32))
    scale = amax / torch.tensor(127.0, dtype=torch.float32, device=g32.device)
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def ef_int8_compress(grads, ef) -> Tuple[Dict, Dict]:
    """Error-feedback int8 rounding of every gradient leaf: returns (the
    dequantized gradients in each leaf's dtype, the new f32 residuals)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = _quant_int8(g32)
        gq = q.to(torch.float32) * scale
        return gq.to(g.dtype), g32 - gq

    out = tree_map(one, grads, ef)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def _member_amax(x, mesh) -> torch.Tensor:
    """max|x| over the whole tensor this rank's pod member holds: for a
    DTensor, its local shard's, all-reduced (max) over the mesh dims that
    shard it, none of which may include ``pod``."""
    from torch.distributed.tensor import Replicate, Shard
    local = x.to_local() if is_dtensor(x) else x
    amax = torch.max(torch.abs(local.to(torch.float32)))
    if not is_dtensor(x):
        return amax
    lmesh, groups = layout_mesh(mesh)
    if x.device_mesh is not lmesh:
        raise ValueError("int8_allreduce_pod: x lives on another mesh")
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and "pod" not in groups[i]:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=lmesh.get_group(i))
        elif not isinstance(pl, Replicate):
            raise ValueError(f"int8_allreduce_pod takes a tensor whole on "
                             f"each pod member, got {x.placements}")
    return amax


def int8_allreduce_pod(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mean over the pod axis with int8 on the wire (all-gather + local
    sum): every pod member's ``x`` (its own value; for a DTensor sharded
    over other axes than ``pod``, the local shard with the scale taken
    over the member's whole tensor)
    quantized per tensor, the codes all-gathered as ``torch.int8`` and the
    scales as f32 over the pod group, dequantized and summed in f32 in
    gather order, divided by the pod size and cast back to ``x``'s dtype.
    Without a ``pod`` axis, or on a pod of one, returns ``x``."""
    if "pod" not in axis_names(mesh) or mesh_shape(mesh)["pod"] == 1:
        return x
    group = mesh.get_group("pod")
    n = mesh_shape(mesh)["pod"]
    local = x.to_local() if is_dtensor(x) else x
    q, scale = _quant_int8(local.to(torch.float32), _member_amax(x, mesh))
    qs = torch.empty((n * q.numel(),), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)  # s8 wire
    qs = qs.reshape((n,) + tuple(q.shape))
    ss = torch.empty((n,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    acc = qs[0].to(torch.float32) * ss[0]
    for i in range(1, n):
        acc = acc + qs[i].to(torch.float32) * ss[i]
    out = (acc / torch.tensor(float(n), dtype=torch.float32,
                              device=acc.device)).to(x.dtype)
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  shape=x.shape, stride=x.stride())
    return out


def int8_allreduce_tree(tree, mesh):
    return tree_map(lambda x: int8_allreduce_pod(x, mesh), tree)
