"""AdamW over nested-dict param trees (port of ``repro.training.optim``).

The optimizer state mirrors the parameter tree (``m``, ``v``, f32) plus an
int32 ``step``.  The order of operations is the reference's: the clip
scale from the f32 global norm, bias corrections from the step, decoupled
weight decay, and the f32 update cast back to each param's dtype.  Every
division is by a tensor: on CUDA, torch divides by a host scalar as a
reciprocal multiply (ROADMAP §3), which is not the reference's rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in
    the reference's order (keys sorted)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_init(params) -> Dict:
    """Zero moments (f32, on each param's device) and step 0 (int32)."""
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, opt_state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step.  Returns (new params, new optimizer state, {"grad_norm":
    the global norm before clipping}); the inputs are not modified.
    ``lr`` is a float or a 0-dim tensor."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, (one * clip_norm) / torch.clamp(gnorm,
                                                               min=1e-12))
    b1c = 1.0 - torch.pow(b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        return m, v, (p32 - lr * delta).to(p.dtype)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(2), {"m": pick(0), "v": pick(1), "step": step}, \
        {"grad_norm": gnorm}
