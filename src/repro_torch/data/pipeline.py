"""Synthetic corpus and the training loader (port of
``repro.data.pipeline``).

The corpus is numpy only: the serving CLIs of both packages draw their
prompts from it, so one command serves the same prompts in both.  The
loader is deterministic by step (:meth:`DataLoader.batch_at`), so a
resumed run sees the exact stream: the data cursor is the step counter.
Its batches are byte-equal to the reference's (the draws are numpy's in
both packages); they land on an explicit device, not a sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


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


def make_passkey_sample(corpus: SyntheticCorpus, length: int, key_pos: int,
                        rng: np.random.Generator, key_len: int = 6
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Needle proxy: hide a key phrase at ``key_pos`` and repeat it at the
    very end, so a model must recall the continuation.  Returns (text,
    key)."""
    text = corpus.sample(length, rng)
    key = rng.integers(2, corpus.vocab, size=key_len)
    text[key_pos:key_pos + key_len] = key
    text[-key_len:] = key
    return text, key


@dataclasses.dataclass
class DataLoader:
    """Batches of ``batch`` sequences of ``seq`` tokens: ``{"tokens": (B,
    S) int32, "labels": (B, S) int32}``, labels the next tokens, on
    ``device`` (CUDA by default; raises without a card unless
    ``"cpu"``)."""
    corpus: SyntheticCorpus
    batch: int
    seq: int
    seed: int = 0
    device: DeviceLike = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.stack([self.corpus.sample(self.seq + 1, rng)
                         for _ in range(self.batch)]).astype(np.int32)
        dev = resolve_device(self.device)
        return {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                "labels": torch.as_tensor(toks[:, 1:], device=dev)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
