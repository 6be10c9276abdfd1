"""Error-feedback int8 gradient compression, the numerics half (port of
``ef_int8_compress`` in ``repro.distributed.compression``, DESIGN.md §5):
quantize ``g + e`` to per-tensor int8 and carry the residual ``e``
forward.  One device: the wire path (``int8_allreduce_pod``, int8 on the
cross-pod all-gather) needs ``torch.distributed`` and is not ported yet
(ROADMAP).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..tree import tree_map


def _quant_int8(g32: torch.Tensor):
    """Per-tensor symmetric int8: (codes, f32 scale = max|g| / 127)."""
    scale = torch.max(torch.abs(g32)) / torch.tensor(
        127.0, dtype=torch.float32, device=g32.device)
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
