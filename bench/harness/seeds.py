"""Seeds derived from the run's ``--seed``: one stream per named input, so
that adding an input never shifts the draws of another."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed for the input named by ``labels`` under ``seed`` (any
    whole number, also one wider than 32 bits)."""
    text = "/".join([str(int(seed))] + [str(x) for x in labels])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
