"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity
dispatch (port of ``repro.models.moe``).

Each token's router picks ``top_k`` experts; an expert takes at most
``_capacity`` tokens of a dispatch group, in the flattened ``(token, k)``
order (token-major), and a token past that capacity is dropped for that
expert.  :func:`moe_ffn_grouped` (the default, GShard/T5X-style) builds
the dispatch and combine tensors from one-hots inside groups of up to
``GROUP_TOKENS`` tokens; :func:`moe_ffn_scatter` scatters the tokens into
one ``(E, C, D)`` buffer.  Both drop the same tokens.  The reference's
sharding annotations are :func:`logical` calls at the same tensors: the
identity outside a sharding context.

Nothing reads the device from the host (no ``.item()``, boolean-mask
indexing, ``nonzero`` or ``bincount``; one-hots are comparisons with an
``arange``), so a decode step through these functions can be captured
as a CUDA graph.  The expert products are library matmuls, as they are
XLA einsums in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import ArchConfig
from .layers import act_fn
from .. import spans
from ..distributed.sharding import logical, seq_whole, seq_whole_grad


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig, *,
          with_aux: bool = True):
    """x (N, D) -> (weights (N, k) f32, expert ids (N, k), aux loss).

    f32 logits and softmax, top-k, the k weights renormalised to sum to
    1; the aux loss is the Switch load-balancing loss (None when
    ``with_aux`` is False: serving never reads it)."""
    probs = torch.softmax(x.to(torch.float32) @ router_w.to(torch.float32),
                          dim=-1)                                 # (N, E)
    vals, ids = torch.topk(probs, cfg.top_k, dim=-1)
    weights = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if not with_aux:
        return weights, ids, None
    e = cfg.n_experts
    # the share of (token, k) picks each expert got: whole counts, summed
    # exactly in f32 (a one-hot sum, which a token-sharded DTensor can
    # reduce across ranks)
    ce = _one_hot(ids.reshape(-1), e, torch.float32).sum(dim=0) / ids.numel()
    aux = e * torch.sum(probs.mean(dim=0) * ce)
    return weights, ids, aux


GROUP_TOKENS = 4096  # tokens per dispatch group


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig, *, with_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), aux loss) by ``cfg.moe_dispatch``
    (the tokens flattened from a whole sequence: ``seq_whole``)."""
    x = seq_whole(x)
    fn = moe_ffn_scatter if cfg.moe_dispatch == "scatter" else moe_ffn_grouped
    out, aux = fn(x, p, cfg, with_aux=with_aux)
    return seq_whole_grad(out), aux


def _experts(xin: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """Every expert's FFN over its rows: xin (E, R, D) -> (E, R, D), one
    batched product per weight with the experts as the batch."""
    a = act_fn(cfg.mlp_act)
    if cfg.mlp_gated:
        h = a(xin @ p["experts_gate"]) * (xin @ p["experts_up"])
    else:
        h = a(xin @ p["experts_up"])
    return h @ p["experts_down"]


def _shared(xf: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """The shared experts (one FFN of width ``n_shared * d_expert``)."""
    a = act_fn(cfg.mlp_act)
    if cfg.mlp_gated:
        hs = a(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
    else:
        hs = a(xf @ p["shared_up"])
    return hs @ p["shared_down"]


def moe_ffn_scatter(x: torch.Tensor, p, cfg: ArchConfig, *,
                    with_aux: bool = True):
    """Global-scatter dispatch: every kept ``(token, k)`` pair is written
    to row ``expert * cap + position`` of one buffer (dropped pairs to a
    dump row past the end), the experts run over the ``(E, cap, D)``
    buffer, and each pair reads its row back weighted by its router
    weight."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    with spans.region("moe.route"):
        weights, ids, aux = route(xf, p["router"], cfg, with_aux=with_aux)
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, cfg)

    with spans.region("moe.dispatch"):
        flat_e = ids.reshape(-1)                              # (N*k,)
        onehot = _one_hot(flat_e, e, torch.int32)             # (N*k, E)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]     # exclusive
        keep = pos < cap
        slot = torch.where(keep, flat_e * cap + pos, e * cap)  # dump row

        tok_idx = torch.arange(n, device=x.device).repeat_interleave(k)
        # like xf (a DTensor on a mesh, so the write is one DTensor op)
        buf = xf.new_zeros((e * cap + 1, d))
        buf[slot] = xf[tok_idx]
        buf = logical(buf[:-1].reshape(e, cap, d), "experts", "cap", None)
    with spans.region("moe.experts"):
        out_e = logical(_experts(buf, p, cfg), "experts", "cap", None
                        ).reshape(e * cap, d)
    with spans.region("moe.combine"):
        out_e = torch.cat([out_e, out_e.new_zeros((1, d))])
        y_slots = out_e[slot] * (weights.reshape(-1)[:, None]
                                 * keep[:, None]).to(x.dtype)
        y = y_slots.reshape(n, k, d).sum(dim=1)
    if cfg.n_shared_experts > 0:
        with spans.region("moe.shared"):
            y = y + _shared(xf, p, cfg)
    return y.reshape(b, s, d), aux


def moe_ffn_grouped(x: torch.Tensor, p, cfg: ArchConfig, *,
                    with_aux: bool = True):
    """Grouped dispatch: the tokens split into ``g`` groups of ``gt``
    (``gt = min(GROUP_TOKENS, n)``, halved until it divides ``n``), each
    with its own capacity; one-hot dispatch ``(G, T, E, C)`` and combine
    tensors move the tokens to ``(G, E, C, D)`` and back.  A dispatch
    entry is 0 or 1 and each ``(expert, position)`` holds one token, so
    the dispatch moves values exactly; the combine sums each token's k
    weighted expert outputs."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    with spans.region("moe.route"):
        weights, ids, aux = route(xf, p["router"], cfg, with_aux=with_aux)
    e, k = cfg.n_experts, cfg.top_k

    gt = min(GROUP_TOKENS, n)
    while n % gt:
        gt //= 2
    g = n // gt
    cap = _capacity(gt, cfg)

    with spans.region("moe.dispatch"):
        xg = logical(xf.reshape(g, gt, d), "batch", None, None)
        w_g = weights.reshape(g, gt, k)
        # position of each (token, k) pair within its expert, inside the
        # group: an int32 exclusive cumsum over the token-major (token, k)
        # order
        oh_i = _one_hot(ids.reshape(g, gt, k), e, torch.int32)  # (G,T,k,E)
        pos = torch.cumsum(oh_i.reshape(g, gt * k, e), dim=1,
                           dtype=torch.int32).reshape(g, gt, k, e) - oh_i
        pos = (pos * oh_i).sum(dim=-1)                          # (G, T, k)
        oh_e = oh_i.to(x.dtype)
        oh_c = _one_hot(pos, cap, x.dtype)     # (G, T, k, C); 0 if dropped

        # dispatch mask and combine weights, (G, T, E, C)
        disp = oh_e.transpose(-1, -2) @ oh_c
        comb = (oh_e * w_g.to(x.dtype)[..., None]).transpose(-1, -2) @ oh_c
        xin = disp.reshape(g, gt, e * cap).transpose(1, 2) @ xg  # (G,E*C,D)
        xin = logical(xin.reshape(g, e, cap, d), "batch", "experts", None,
                      None)
        xin = xin.transpose(0, 1).reshape(e, g * cap, d)
    with spans.region("moe.experts"):
        out_e = _experts(xin, p, cfg)
    with spans.region("moe.combine"):
        out_e = out_e.reshape(e, g, cap, d).transpose(0, 1)
        out_e = logical(out_e, "batch", "experts", None, None)
        y = comb.reshape(g, gt, e * cap) @ out_e.reshape(g, e * cap, d)
        y = logical(y, "batch", None, None).reshape(n, d)
    if cfg.n_shared_experts > 0:
        with spans.region("moe.shared"):
            y = y + _shared(xf, p, cfg)
    return y.reshape(b, s, d), aux
