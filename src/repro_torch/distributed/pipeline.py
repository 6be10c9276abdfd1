"""GPipe-style pipeline parallelism over the ``pod`` axis (port of
``repro.distributed.pipeline``, DESIGN.md §5).

The schedule is the reference's collective-permute ladder: stage s holds
layers [s·L/S, (s+1)·L/S); over M + S - 1 ticks stage 0 injects
microbatch t, every other stage takes the activations the previous stage
sent at the tick before, and the last stage harvests microbatch
t - S + 1; bubbles = (S-1)/(M+S-1).  The ring permute i -> i+1 mod S is
one ``dist.batch_isend_irecv`` a tick on the process group of the mesh's
``axis`` dim; the result goes from the last stage to every stage by one
broadcast (the reference's masked ``psum`` adds zeros to the same
values).  Each rank runs its stage's layers one by one, as the
reference's scan over the stage-local slice does.  The port's pipeline
is a forward: no gradient flows back through the sends.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..tree import leaves, tree_map
from .sharding import mesh_shape


def pipeline_forward(block_fn: Callable, params_stacked, x, *, mesh,
                     axis: str = "pod", microbatches: int = 4):
    """Run ``block_fn`` over layer-stacked params, pipelined over ``axis``.

    block_fn(h, layer_params) -> h        (one transformer block)
    params_stacked: tree with leading layer dim L (L % n_stages == 0), the
        whole stack on every rank; each stage uses its own slice.
    x: (B, ...) activations (B % microbatches == 0), the same on every
        rank; only stage 0 reads them.

    Returns, on every rank, the same value as sequentially applying all L
    layers.
    """
    n_stages = mesh_shape(mesh)[axis]
    l_total = leaves(params_stacked)[0].shape[0]
    assert l_total % n_stages == 0, (l_total, n_stages)
    per_stage = l_total // n_stages
    b = x.shape[0]
    assert b % microbatches == 0, (b, microbatches)
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    peer = lambda s: dist.get_global_rank(group, s % n_stages)
    params_local = tree_map(
        lambda a: a[sid * per_stage:(sid + 1) * per_stage], params_stacked)
    mb = x.reshape(microbatches, b // microbatches, *x.shape[1:])

    def run_stage(h):
        for i in range(per_stage):
            h = block_fn(h, tree_map(lambda a: a[i], params_local))
        return h

    buf = torch.zeros_like(mb[0])
    out = torch.zeros_like(mb)
    for t in range(microbatches + n_stages - 1):
        # stage 0 injects microbatch t (if any), others take the relayed
        # activations from the previous stage
        h_in = mb[min(t, microbatches - 1)] if sid == 0 else buf
        h_out = run_stage(h_in)
        # last stage harvests microbatch (t - n_stages + 1)
        slot = t - (n_stages - 1)
        if slot >= 0 and sid == n_stages - 1:
            out[slot] = h_out
        if n_stages == 1:
            buf = h_out
            continue
        buf = torch.empty_like(h_out)
        ops = [dist.P2POp(dist.isend, h_out.contiguous(), peer(sid + 1),
                          group),
               dist.P2POp(dist.irecv, buf, peer(sid - 1), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # only the last stage's `out` is real; send it to all stages
    if n_stages > 1:
        dist.broadcast(out, peer(n_stages - 1), group=group)
    return out.reshape(b, *x.shape[1:])
