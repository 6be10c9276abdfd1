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
reference's scan over the stage-local slice does.

The pipeline is differentiable, as the reference's is through
``ppermute``: each tick's ring permute is an autograd function whose
backward sends the cotangent the other way round the ring (stage i+1 to
stage i), the broadcast's backward hands the last stage its own
cotangent, and the params and ``x``, whole on every rank, get their
gradients summed over the stages (each stage's reaches only its own
layers, and only stage 0's reaches ``x``).  Every rank's graph holds
every tick, so every rank runs the same sends in the same order.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..tree import leaves, tree_map, unflatten
from .sharding import mesh_shape


class _RingShift(torch.autograd.Function):
    """Send ``h`` to the next stage, return what the previous one sent;
    the backward sends the cotangent to the previous stage and returns
    what the next one sent back."""

    @staticmethod
    def forward(ctx, h, nxt, prv, group):
        ctx.peers = (nxt, prv, group)
        return _exchange(h, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prv, group = ctx.peers
        return _exchange(g, prv, nxt, group), None, None, None


def _exchange(h, to, frm, group):
    buf = torch.empty_like(h)
    ops = [dist.P2POp(dist.isend, h.contiguous(), to, group),
           dist.P2POp(dist.irecv, buf, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


class _Pick(torch.autograd.Function):
    """``a`` on stage 0 (the injected microbatch), else ``b`` (the ring's
    buffer), the other input getting a zero cotangent: the reference's
    ``where(sid == 0, inject, buf)``, which keeps both in every rank's
    graph."""

    @staticmethod
    def forward(ctx, a, b, first):
        ctx.first = first
        return (a if first else b).clone()

    @staticmethod
    def backward(ctx, g):
        z = torch.zeros_like(g)
        return (g, z, None) if ctx.first else (z, g, None)


class _Broadcast(torch.autograd.Function):
    """The last stage's ``out`` on every rank; the backward hands the last
    stage its own cotangent (every rank holds the same value, so the same
    cotangent) and the others none.  ``anchor`` (the stage's last tick)
    keeps every tick in the rank's graph and gets a zero cotangent."""

    @staticmethod
    def forward(ctx, out, anchor, src, group, is_src):
        ctx.is_src = is_src
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        out = out.clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return (g if ctx.is_src else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None, None,
                None)


class _SumGrads(torch.autograd.Function):
    """The identity on the whole-on-every-rank inputs, whose backward sums
    their gradients over the stages in one all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, k = [], 0
        for g in gs:
            out.append(flat[k:k + g.numel()].view_as(g))
            k += g.numel()
        return (None, *out)


def pipeline_forward(block_fn: Callable, params_stacked, x, *, mesh,
                     axis: str = "pod", microbatches: int = 4):
    """Run ``block_fn`` over layer-stacked params, pipelined over ``axis``.

    block_fn(h, layer_params) -> h        (one transformer block)
    params_stacked: tree with leading layer dim L (L % n_stages == 0), the
        whole stack on every rank; each stage uses its own slice.
    x: (B, ...) activations (B % microbatches == 0), the same on every
        rank; only stage 0 reads them.

    Returns, on every rank, the same value as sequentially applying all L
    layers, differentiable in the params and ``x``.
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
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params_stacked) + [x])
    if grad and n_stages > 1:
        flat = _SumGrads.apply(group, *leaves(params_stacked), x)
        params_stacked, x = unflatten(params_stacked, flat[:-1]), flat[-1]
    params_local = tree_map(
        lambda a: a[sid * per_stage:(sid + 1) * per_stage], params_stacked)
    mb = x.reshape(microbatches, b // microbatches, *x.shape[1:])

    def run_stage(h):
        for i in range(per_stage):
            h = block_fn(h, tree_map(lambda a: a[i], params_local))
        return h

    if n_stages == 1:
        return torch.cat([run_stage(mb[t]) for t in range(microbatches)]
                         ).reshape(b, *x.shape[1:])
    # a leaf that asks for a gradient: every tick's buffer is then in the
    # graph on every rank, whatever reaches each stage
    buf = torch.zeros_like(mb[0]).requires_grad_(grad)
    outs = []
    n_ticks = microbatches + n_stages - 1
    for t in range(n_ticks):
        # stage 0 injects microbatch t (if any), others take the relayed
        # activations from the previous stage
        h_in = _Pick.apply(mb[min(t, microbatches - 1)], buf, sid == 0)
        h_out = run_stage(h_in)
        # last stage harvests microbatch (t - n_stages + 1)
        if t >= n_stages - 1 and sid == n_stages - 1:
            outs.append(h_out)
        if t < n_ticks - 1:     # the last tick's sends would go unread
            buf = _RingShift.apply(h_out, peer(sid + 1), peer(sid - 1),
                                   group)
    # only the last stage's `out` is real; send it to all stages
    out = torch.stack(outs) if outs else torch.zeros_like(mb)
    out = _Broadcast.apply(out, h_out, peer(n_stages - 1), group,
                           sid == n_stages - 1)
    return out.reshape(b, *x.shape[1:])
