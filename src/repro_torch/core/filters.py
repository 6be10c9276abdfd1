"""Important-KV filter rules (port of ``repro.core.filters``; paper Sec.
3.2, "Important KV Cache Filter"; DESIGN.md §1).

A filter rule decides, for each token sliding out of the fp window,
whether it stays at full precision instead of being quantized.  The paper
enables one rule, the attention sink (the first ``n_sink`` tokens), which
the cache implements natively with its sink buffer.  The interface is the
hook for more; :class:`HeavyHitterFilter` states the contract of a
score-based rule and, as in the paper, is not enabled.
"""
from __future__ import annotations

from typing import Protocol

import torch


class FilterRule(Protocol):
    """Returns True (per token) where the token must stay at full
    precision."""

    def keep_fp(self, positions: torch.Tensor, stats: dict) -> torch.Tensor:
        ...


class AttentionSinkFilter:
    """Keep the first ``n_sink`` tokens at full precision (on by default)."""

    def __init__(self, n_sink: int = 5):
        self.n_sink = n_sink

    def keep_fp(self, positions: torch.Tensor, stats: dict) -> torch.Tensor:
        return positions < self.n_sink


class HeavyHitterFilter:
    """Keep the tokens whose accumulated attention mass reaches the
    ``quantile`` of all of them (linear interpolation, as
    ``jnp.quantile``).  ``stats["attn_mass"]`` has the shape of
    ``positions``."""

    def __init__(self, quantile: float = 0.99):
        self.quantile = quantile

    def keep_fp(self, positions: torch.Tensor, stats: dict) -> torch.Tensor:
        mass = stats["attn_mass"]
        thresh = torch.quantile(mass, self.quantile)
        return mass >= thresh


def combine(filters, positions: torch.Tensor, stats: dict) -> torch.Tensor:
    """A token stays fp if ANY rule keeps it (Alg. 1 ands the quantize
    masks, i.e. ors the keep masks)."""
    keep = torch.zeros_like(positions, dtype=torch.bool)
    for f in filters:
        keep = keep | f.keep_fp(positions, stats)
    return keep
