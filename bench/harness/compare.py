"""The numbers ``correct`` compares, from the gaps of the served tokens.

A gap is how far a served token's logit lies below the reference's best
at its position (0 where the program served the reference's own pick).
A cell's limits file (``bench/limits/<workload>.json``) names which of
:data:`STATS` it compares and the limit of each; every statistic is
computed and kept for the record."""
from __future__ import annotations

from typing import Dict, List

import torch

from .runner import Check

STATS = {
    "max_logit_gap": lambda g: g.max(),
    "mean_logit_gap": lambda g: g.mean(),
}


def stats(gaps: torch.Tensor) -> Dict[str, float]:
    g = gaps.detach().double().flatten().cpu()
    if g.numel() == 0:
        return {k: float("inf") for k in STATS}
    return {k: float(f(g)) for k, f in STATS.items()}


def checks(gaps: torch.Tensor, limits: dict) -> List[Check]:
    got = stats(gaps)
    return [Check(k, got[k], float(limits[k])) for k in STATS if k in limits]
