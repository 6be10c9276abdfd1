"""Shared quality-evaluation harness (port of ``benchmarks/common.py``).

All quality studies run on a small llama-family model trained a few hundred
steps on the synthetic corpus (cached across runs), so K/V activations carry
realistic channel structure.  Methods are evaluated with *position-correct*
sliding-window semantics: when query ``t`` attends token ``j``, the fp version
of K/V is used iff ``t - j < window`` or ``j < sinks`` — exactly the paper's
decode-phase behaviour, vectorized over the whole sequence (two-matmul split
of the attention output, no approximation).

Metric: teacher-forced perplexity on held-out synthetic text (the offline
stand-in for LongBench scores; relative ordering is what the paper's tables
establish).

Every fake quantization goes through ``quant_fn`` (``None``:
``core.calibrate.resolve_quant_fn``'s choice, the bulk ``kv_quant`` kernel
on CUDA tensors and the plain ``quantize_groups`` on CPU ones), in the
methods and in each calibration's clip search alike.  The entry points run
on the card unless the caller passes ``device="cpu"``.  The studies time
nothing: a row is ``name,derived``.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.baselines import METHODS, MethodCtx
from ..core.calibrate import calibrate_layer
from ..core.policy import QuantPolicy, as_schedule
from ..data import DataLoader, SyntheticCorpus
from ..device import resolve_device
from ..models import layers as L
from ..models import transformer as T
from ..training import init_train_state, make_train_step, warmup_cosine

EXPERIMENTS = Path(__file__).resolve().parents[3] / "experiments"
BENCH_DIR = EXPERIMENTS / "bench_model_torch"
BENCH_ARCH = "llama3p2_1b"
TRAIN_STEPS = 300
EVAL_BATCH, EVAL_SEQ = 8, 256


def train_or_restore(cache_dir, cfg, corpus, train_steps: int, *,
                     init_key: int = 0, dl_seed: int = 5, device=None):
    """Train a small model ``train_steps`` steps (or restore the cached
    checkpoint — keyed by directory, so distinct step counts must use
    distinct dirs) and return its params, on ``device``.  Shared by every
    quality study that needs K/V activations with realistic channel
    structure.  ``init_key`` seeds the port's init (not ``jax.random``'s)."""
    dev = resolve_device(device)
    state = init_train_state(cfg, seed=init_key, device=dev)
    mgr = CheckpointManager(str(cache_dir), save_every=train_steps)
    restored = mgr.restore_or_none(state, device=dev)
    if restored and restored["step"] >= train_steps - 1:
        return restored["state"]["params"]
    dl = DataLoader(corpus, batch=16, seq=128, seed=dl_seed, device=dev)
    lr = functools.partial(warmup_cosine, peak_lr=5e-3, warmup=20,
                           total=train_steps)
    step = make_train_step(cfg, lr_fn=lr)
    for i in range(train_steps):
        state, _ = step(state, dl.batch_at(i))
    mgr.maybe_save(train_steps, state)
    return state["params"]


def bench_config():
    """The stand-in model: the smoke llama3.2-1b at 2 layers, d 128, 4
    heads / 2 kv of 32, d_ff 256 (vocab 256)."""
    return configs.get_smoke(BENCH_ARCH).scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256)


def bench_model(cache_dir=None, device=None, train_steps: int = TRAIN_STEPS):
    """Train (or restore) the benchmark model on ``device`` into
    ``cache_dir`` (default ``experiments/bench_model_torch``); returns
    (cfg, params, corpus)."""
    return _bench_model(str(cache_dir or BENCH_DIR),
                        str(resolve_device(device)), train_steps)


@functools.lru_cache(maxsize=2)
def _bench_model(cache_dir: str, device: str, train_steps: int):
    cfg = bench_config()
    corpus = SyntheticCorpus(cfg.vocab_size, seed=11)
    params = train_or_restore(cache_dir, cfg, corpus, train_steps,
                              device=device)
    return cfg, params, corpus


def eval_tokens(corpus, n=EVAL_BATCH, s=EVAL_SEQ, seed=999, device=None):
    """(n, s) held-out tokens, sequence i drawn with rng ``seed + i`` (the
    reference's draws: ``SyntheticCorpus`` is the same generator)."""
    return torch.as_tensor(
        np.stack([corpus.sample(s, np.random.default_rng(seed + i))
                  for i in range(n)]).astype(np.int64),
        device=resolve_device(device))


def calibrate(cfg, params, corpus, policy: QuantPolicy, seed=0,
              quant_fn: Optional[Callable] = None):
    """Per-layer calibration for one uniform policy (the schedule path with
    every layer alike — see :func:`calibrate_schedule`)."""
    return calibrate_schedule(cfg, params, corpus,
                              as_schedule(policy, cfg.n_layers), seed=seed,
                              quant_fn=quant_fn)


# ---------------------------------------------------- position-correct eval

def _windowed_attention(q, k, v, kq, vq, window: int, sinks: int, cfg):
    """Attention where token j is fp for query t iff t-j < window or j < sinks.

    q (B, S, Hq, D), k/v/kq/vq (B, S, Hkv, D); scores and probabilities in
    f32 ((B, Hkv, Hq/Hkv, S, S) each), the output in q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    pos = torch.arange(s, device=q.device)
    recent = (pos[:, None] - pos[None, :] < window) | (pos[None, :] < sinks)
    causal = pos[:, None] >= pos[None, :]
    scale = cfg.query_scale if cfg.query_scale > 0 else d ** -0.5
    qg = q.reshape(b, s, hkv, g, d).to(torch.float32) * scale

    def scores(kk):
        return torch.einsum("bskgd,btkd->bkgst", qg, kk.to(torch.float32))

    sel = torch.where(recent, scores(k), scores(kq))
    sel = torch.where(causal, sel, torch.full_like(sel, -1e30))
    p = torch.softmax(sel, dim=-1)
    del sel
    p_fp = p * recent
    p_q = p * ~recent
    del p
    o = (torch.einsum("bkgst,btkd->bskgd", p_fp, v.to(torch.float32)) +
         torch.einsum("bkgst,btkd->bskgd", p_q, vq.to(torch.float32)))
    return o.reshape(b, s, hq, d).to(q.dtype)


def _layer_mixed_forward(params, cfg, tokens, method_for: Callable,
                         calibs: Optional[List] = None,
                         quant_fn: Optional[Callable] = None):
    """Shared proxy-ppl forward: ``method_for(i) -> (method_fn, policy)``
    picks layer ``i``'s K/V transform (a ``core.baselines`` function) and
    the policy supplying its window/sink mixing — one loop serves both the
    uniform method rows and the per-layer schedule rows (DESIGN.md §8).
    The dense family only, every layer global, as in the reference."""
    if cfg.family != "dense":
        raise ValueError(f"the proxy-ppl forward serves the dense family "
                         f"only, not {cfg.name} ({cfg.family})")
    x = L.embed(tokens, params["embed"], cfg.embed_scale)
    b, s, _ = x.shape
    rope = T._rope_tables(cfg, torch.arange(s, dtype=torch.int32,
                                            device=x.device))[0]
    for i in range(cfg.n_layers):
        method, pol = method_for(i)
        p = T._layer_params(params, cfg, i)
        h = L.norm(x, p["norm1"], cfg)
        q, k, v = T._qkv(h, p["attn"], cfg, rope)
        ctx = MethodCtx(pol.without_window() if pol else None,
                        calibs[i] if calibs else None, quant_fn)
        kq, vq = method(k, v, ctx)
        attn = _windowed_attention(q, k, v, kq, vq,
                                   pol.window if pol else 0,
                                   pol.n_sink if pol else 0, cfg)
        x = x + T._attn_out(attn, p["attn"])
        x = x + T._ffn(L.norm(x, p["norm2"], cfg), p, cfg)
    x = L.norm(x, params["final_norm"], cfg)
    return L.unembed(x, params, cfg)


def forward_with_method(params, cfg, tokens, method: Callable,
                        calibs: Optional[List] = None,
                        policy: Optional[QuantPolicy] = None,
                        quant_fn: Optional[Callable] = None):
    """Dense-family forward where EVERY layer's K/V pass through ``method``
    with position-correct window mixing (the uniform special case of
    :func:`_layer_mixed_forward`)."""
    return _layer_mixed_forward(params, cfg, tokens,
                                lambda i: (method, policy), calibs, quant_fn)


def ppl_with_method(params, cfg, tokens, method, calibs=None, policy=None,
                    quant_fn: Optional[Callable] = None) -> float:
    logits = forward_with_method(params, cfg, tokens, method, calibs, policy,
                                 quant_fn)
    return _ppl(logits, tokens)


def _ppl(logits, tokens) -> float:
    """Teacher-forced perplexity of ``tokens`` under ``logits``, in f32."""
    lg = logits.to(torch.float32)[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    return float(torch.exp((lse - gold).mean()))


# ------------------------------------------------- per-layer schedule eval

def calibrate_schedule(cfg, params, corpus, schedule, seed=0,
                       quant_fn: Optional[Callable] = None):
    """Per-layer calibration table for a :class:`PolicySchedule`: layer
    ``l`` is calibrated against its OWN policy (alpha group counts are
    policy-dependent), so mixed-precision ladders and fp16 guard layers
    each get the right artifacts (DESIGN.md §8), with seed ``seed + l``.
    The samples are ``collect_kv`` over ``eval_tokens(n=8, s=128,
    seed=12345)`` on the params' device; the clip search quantizes through
    ``quant_fn``."""
    schedule = as_schedule(schedule, cfg.n_layers)
    toks = eval_tokens(corpus, n=8, s=128, seed=12345,
                       device=params["embed"].device)
    ks, vs = T.collect_kv(params, cfg, toks)
    return [calibrate_layer(ks[l], vs[l], schedule[l], seed=seed + l,
                            quant_fn=quant_fn)
            for l in range(ks.shape[0])]


def forward_with_schedule(params, cfg, tokens, schedule, calibs=None,
                          quant_fn: Optional[Callable] = None):
    """Dense-family forward under a per-layer :class:`PolicySchedule`: each
    layer's K/V pass through its own policy's SKVQ method (fp16 guard layers
    skip quantization entirely) with that layer's position-correct window
    mixing — the proxy-ppl evaluator for mixed schedules (DESIGN.md §8)."""
    schedule = as_schedule(schedule, cfg.n_layers)

    def pick(i):
        pol = schedule[i]
        return (METHODS["fp16"] if pol.is_fp16 else METHODS["skvq"]), pol

    return _layer_mixed_forward(params, cfg, tokens, pick, calibs, quant_fn)


def ppl_with_schedule(params, cfg, tokens, schedule, calibs=None,
                      quant_fn: Optional[Callable] = None) -> float:
    return _ppl(forward_with_schedule(params, cfg, tokens, schedule, calibs,
                                      quant_fn), tokens)


def bits_breakdown(schedule, head_dim: int) -> str:
    """Compact per-layer bits string for rows, e.g. ``16/2.75/2.75/16``
    (the per-layer avg-bits breakdown)."""
    return "/".join(f"{b:g}" for b in schedule.layer_avg_bits(head_dim))


def row(name: str, derived: str) -> str:
    """One result row, ``name,derived`` (the reference's CSV row without
    its timing column)."""
    return f"{name},{derived}"
