"""Paper Figure 5/7 (needle-in-a-haystack) — offline retrieval-fidelity proxy
(port of ``benchmarks/needle_proxy.py``).

No pretrained retrieval-capable model is at hand, so the proxy measures what
quantization does to *decode fidelity as a function of distance into the
quantized region*: a passkey phrase is planted at depth p; we compare the
next-token distribution of the quantized-cache decode against the fp16
decode at the query position (top-1 agreement + KL).  SKVQ (with sinks) must
beat windowless RTN at every depth, mirroring the paper's KIVI comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.baselines import METHODS
from ..core.policy import FP16_POLICY, QuantPolicy
from ..data import make_passkey_sample
from ..device import resolve_device
from . import common as C

DEPTHS = (0.1, 0.3, 0.5, 0.7, 0.9)
SEQ = 256


def _agree(params, cfg, toks, method, calibs, pol):
    """(top-1 agreement, KL(fp16 || quantized)) of the last position's
    next-token distribution, averaged over the batch."""
    logits = C.forward_with_method(params, cfg, toks, method, calibs, pol)
    ref = C.forward_with_method(params, cfg, toks, METHODS["fp16"], calibs,
                                FP16_POLICY)
    p = torch.softmax(logits.to(torch.float32)[:, -1], -1)
    q = torch.softmax(ref.to(torch.float32)[:, -1], -1)
    kl = float((q * (torch.log(q + 1e-9) - torch.log(p + 1e-9))).sum(-1)
               .mean())
    agree = float((logits[:, -1].argmax(-1) == ref[:, -1].argmax(-1))
                  .to(torch.float32).mean())
    return agree, kl


def run(emit, *, cache_dir=None, device=None):
    cfg, params, corpus = C.bench_model(cache_dir, device)
    pol_skvq = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=32,
                           n_sink=5)
    pol_rtn = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=0,
                          n_sink=0, clip=False, reorder=False)
    calibs = C.calibrate(cfg, params, corpus, pol_skvq)
    scores = {"skvq": [], "rtn": []}
    for depth in DEPTHS:
        toks = np.stack([make_passkey_sample(corpus, SEQ,
                                             int(depth * (SEQ - 40)) + 8,
                                             np.random.default_rng(i))[0]
                         for i in range(4)])
        toks = torch.as_tensor(toks.astype(np.int64),
                               device=resolve_device(device))
        a_s, kl_s = _agree(params, cfg, toks, METHODS["skvq"], calibs,
                           pol_skvq)
        a_r, kl_r = _agree(params, cfg, toks, METHODS["rtn"], calibs,
                           pol_rtn)
        scores["skvq"].append(a_s)
        scores["rtn"].append(a_r)
        emit(C.row(f"fig5_depth{depth}",
                   f"skvq_agree={a_s:.2f},rtn_agree={a_r:.2f},"
                   f"skvq_kl={kl_s:.4f},rtn_kl={kl_r:.4f}"))
    better = float(np.mean(scores["skvq"])) >= float(np.mean(scores["rtn"]))
    emit(C.row("fig5_skvq_beats_rtn", f"holds={better}"))
    return scores
