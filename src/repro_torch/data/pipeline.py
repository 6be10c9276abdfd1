"""Synthetic prompt corpus, numpy only (port of ``SyntheticCorpus`` in
``repro.data.pipeline``): the serving CLIs of both packages draw their
prompts from it, so one command serves the same prompts in both."""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Markov bigram + motif corpus over a Zipf vocabulary: each token
    moves to one of ``branching`` successors with Zipf weights, and a
    ``motif_len``-token motif is spliced in with probability 0.02 per
    token.  Ids are drawn from ``[2, vocab_size)``.  The draws match the
    reference's one for one, so equal seeds give equal arrays."""

    def __init__(self, vocab_size: int, seed: int = 0, n_motifs: int = 32,
                 motif_len: int = 12, branching: int = 24):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        v_eff = max(vocab_size - 2, 2)
        self.next_tok = self.rng.integers(2, 2 + v_eff,
                                          size=(vocab_size, branching))
        zipf_w = 1.0 / (np.arange(branching) + 1.0)
        self.next_p = zipf_w / zipf_w.sum()
        self.motifs = self.rng.integers(2, 2 + v_eff,
                                        size=(n_motifs, motif_len))

    def sample(self, length: int, rng: np.random.Generator) -> np.ndarray:
        """``length`` tokens (int64) drawn with ``rng``."""
        out = np.empty(length, np.int64)
        t = int(rng.integers(2, self.vocab))
        i = 0
        while i < length:
            if rng.random() < 0.02:                   # motif insertion
                m = self.motifs[rng.integers(len(self.motifs))]
                n = min(len(m), length - i)
                out[i:i + n] = m[:n]
                i += n
                t = int(out[i - 1])
                continue
            t = int(self.next_tok[t, rng.choice(len(self.next_p),
                                                p=self.next_p)])
            out[i] = t
            i += 1
        return out
