"""The one traffic generator: it reads a mix's parameters from its data file
(``bench/traffic/<name>.json``) and makes the run's requests from the seed.

A decode-rounds mix (``slots``, ``context``, ``round_tokens``) starts every
round from the same filled caches; the seed draws the caches' K/V
(:mod:`harness.inputs`) and the token each slot decodes from."""
from __future__ import annotations

import numpy as np

from .seeds import sub_seed


def decode_start(seed: int, round_index: int, slots: int,
                 vocab: int) -> np.ndarray:
    """The token each slot decodes from at the start of a round, (slots,)."""
    rng = np.random.default_rng(sub_seed(seed, "round_start", round_index))
    return rng.integers(0, vocab, size=slots, dtype=np.int64)
