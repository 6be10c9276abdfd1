"""LR schedule (port of ``repro.training.schedule``): a pure function of
the step, computed in f32 on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr=3e-4, warmup=100, total=10_000,
                  floor=0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``: an f32 0-dim tensor.
    ``step`` is an int or a tensor.  The divisions are by tensors (the
    reference's rounding on CUDA too, ROADMAP §3)."""
    s = (step.to(torch.float32) if torch.is_tensor(step)
         else torch.tensor(float(step), dtype=torch.float32))
    den = lambda n: torch.tensor(float(n), dtype=torch.float32,
                                 device=s.device)
    warm = s / den(max(warmup, 1))
    prog = torch.clamp((s - warmup) / den(max(total - warmup, 1)), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)
