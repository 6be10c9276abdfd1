"""The kernel and decode-path suite (counterpart of
``benchmarks/kernel_bench.py``): packed against fp16 attention bytes and
times, the ragged-occupancy sweep of block pruning, ``decode_step``
through each decode backend, and the ``ServeSession`` sync rows.

Where the reference compares XLA's memory analysis of two compiled
functions, the argument and cache bytes here come from the tensors the
two functions take; both times are device times on the card
(``common.timed``; host times of the plain versions on the CPU).  The
packed path is the ``decode_attn`` kernel itself.

Two hard gates, as in the reference: block pruning must visit at least 4x
fewer blocks than the capacity walk at 25% occupancy, and the logits of
``decode_step`` through every backend must agree within 2e-2 of the
``"reference"`` backend's.  Every row carries ``occupancy=``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.policy import QuantPolicy
from ..device import resolve_device
from . import common as C

B, S, H, D, GQ = 4, 4096, 8, 128, 4
PRUNE_GATE = 4.0          # x fewer blocks at 25% occupancy
DRIFT_GATE = 2e-2         # max |logit| difference across backends


def _iters(dev) -> int:
    return 20 if dev.type == "cuda" else 1


def _us(fn, dev) -> float:
    """Mean µs a call (``common.timed``, one timing)."""
    return C.timed(fn, dev, iters=_iters(dev), repeats=1,
                   warmup=1)["mean"] * 1e3


def check_prune_gate(reduction: float) -> None:
    """The sweep's acceptance gate: >= 4x fewer blocks at 25% occupancy."""
    if reduction < PRUNE_GATE:
        raise AssertionError(
            f"block pruning regressed: {reduction:.2f}x < 4x fewer blocks at "
            f"25% occupancy")


def _bench_ragged_occupancy(emit, smoke: bool, device=None) -> dict:
    """Block pruning: blocks visited and packed bytes a step against
    occupancy, pruned and unpruned times (``decode_block_report``,
    ``cuda_decode_attention(prune_blocks=)``), on global layers and on
    local ones (window ``bs + 8``).  Returns ``{(occupancy, layer kind):
    {"visited", "total", "bytes_per_block", "reduction"}}``."""
    from ..core import kv_cache as kvc
    from ..kernels.ops import (cuda_decode_attention, decode_block_report,
                               make_kernel_quant_fn)
    from ..models.backends import CudaBackend

    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    hkv, hq, d = 2, 4, 64
    bs = 64
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=min(64, d),
                      window=16, n_sink=4)
    cap_q = 512 if smoke else 2048           # packed-region capacity (tokens)
    max_len = cap_q + pol.n_sink + pol.window
    b = 2
    info = dict(CudaBackend().info(), block_s=bs, device=str(dev), slots=b,
                packed_cap=cap_q)
    emit(C.csv_row("kernel_backend_info", 0.0,
                   ";".join(f"{k}={v}" for k, v in sorted(info.items()))))
    qf = make_kernel_quant_fn()
    out = {}
    for occ in (0.01, 0.25, 1.0):
        live_q = max(1, int(round(cap_q * occ)))
        length = live_q + pol.n_sink + pol.window
        k, v = (torch.as_tensor(rng.normal(size=(b, length, hkv, d)),
                                dtype=torch.float32, device=dev)
                for _ in range(2))
        cache = kvc.prefill(k, v, max_len, pol, quant_fn=qf)
        q = torch.as_tensor(rng.normal(size=(b, 1, hq, d)),
                            dtype=torch.float32, device=dev)
        for lname, w in (("global", None), ("local", bs + 8)):
            rep = decode_block_report(cache, pol, d, window=w, block_s=bs)
            vis = int(rep["visited"].sum())
            total = b * rep["total"]
            bpb = rep["bytes_per_block"]
            times = {tag: _us(lambda _p=prune: cuda_decode_attention(
                q, cache, pol, scale=d ** -0.5, window=w, block_s=bs,
                dtype=torch.float32, prune_blocks=_p), dev)
                for tag, prune in (("pruned", True), ("unpruned", False))}
            emit(C.csv_row(
                f"kernel_ragged_occ{int(occ * 100)}pct_{lname}",
                times["pruned"],
                f"occupancy={occ:.2f},blocks_visited={vis},"
                f"blocks_unpruned={total},block_reduction={total / vis:.2f}x,"
                f"bytes_step_pruned={vis * bpb},"
                f"bytes_step_unpruned={total * bpb},"
                f"us_unpruned={times['unpruned']:.1f}"))
            out[(occ, lname)] = {"visited": vis, "total": total,
                                 "bytes_per_block": bpb,
                                 "reduction": total / vis}
    red = out[(0.25, "global")]["reduction"]
    emit(C.csv_row("kernel_ragged_prune_gate", 0.0,
                   f"occupancy=0.25,block_reduction={red:.2f}x (gate: >=4x)"))
    check_prune_gate(red)
    return out


def _fp16_attn(q, k, v):
    """q (B, H, G, D) f32 over k, v (B, H, T, D): the reference's
    ``_fp16_attn`` (no query scale)."""
    s = torch.einsum("bhgd,bhtd->bhgt", q, k.to(torch.float32))
    p = torch.softmax(s, -1)
    return torch.einsum("bhgt,bhtd->bhgd", p, v.to(torch.float32))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bench_decode_step_backends(emit, smoke: bool, device=None,
                                params=None) -> dict:
    """The FULL ``decode_step`` through each registered backend (not the
    bare kernel), the drift gate, and ``ServeSession`` at one host sync a
    token against one a chunk.  ``params`` (the smoke llama3.2-1b's;
    default: seeded random) lets a caller bring its own weights.  Returns
    the first step's logits by backend, the drift, and each sync
    setting's streams and measured host syncs."""
    from .. import configs
    from ..models import backends as BK
    from ..models import transformer as T
    from ..serving import ServeSession

    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    cfg = configs.get_smoke("llama3p2_1b")
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=min(64, cfg.head_dim),
                      window=16, n_sink=4)
    if params is None:
        params = T.init_params(cfg, seed=0, device=dev)
    s, reps = (32, 2) if smoke else (96, 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, s)),
                           device=dev)
    with torch.no_grad():
        _, base = T.prefill_model(params, cfg, toks, pol, max_len=s + 32)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)),
                          device=dev)

    occ = s / (s + 32)   # live / per-slot cache capacity
    logits = {}
    for name in BK.available_backends():
        # decode_step appends in place: each backend steps its own copy
        caches = {g: {k: v.clone() for k, v in c.items()}
                  for g, c in base.items()}
        step = lambda: T.decode_step(params, cfg, nxt, caches, pol,
                                     backend=name)[0]
        with torch.no_grad():
            logits[name] = step().float().cpu()
            us = C.timed(step, dev, iters=reps, repeats=1,
                         warmup=0)["mean"] * 1e3
        note = ("plain versions (CPU correctness path, not perf)"
                if name == "cuda" and dev.type != "cuda" else "eager")
        emit(C.csv_row(f"decode_step_backend_{name}", us,
                       f"occupancy={occ:.2f},{note}"))
    drift = max(float((logits[n] - logits["reference"]).abs().max())
                for n in logits)
    emit(C.csv_row("decode_step_backend_drift", 0.0,
                   f"max_abs_logit_diff={drift:.2e} (gate: 2e-2)"))
    if drift > DRIFT_GATE:  # hard gate: the CLI reports the suite failed
        raise AssertionError(f"backend parity drift {drift:.3e} > 2e-2")

    # the Engine syncs with the host once a chunk of steps_per_sync steps
    max_new = 8 if smoke else 16
    prompts = np.asarray(rng.integers(0, cfg.vocab_size, (2, s)), np.int32)
    streams, syncs = {}, {}
    for n_sync in (1, max_new):
        sess = ServeSession(params, cfg, pol, batch_slots=2, max_len=s + 32,
                            steps_per_sync=n_sync, device=dev)
        sess.generate(prompts, max_new=max_new)  # warm
        steps0 = sess.engine.n_decode_steps
        us = C.host_ms(lambda: streams.__setitem__(
            n_sync, sess.generate(prompts, max_new=max_new)), dev) * 1e3
        syncs[n_sync] = (sess.engine.n_decode_steps - steps0) // n_sync
        emit(C.csv_row(f"engine_generate_sync{n_sync}", us,
                       f"occupancy={(s + max_new) / (s + 32):.2f},"
                       f"max_new={max_new},host_syncs={syncs[n_sync]}"))
    return {"logits": logits, "drift": drift, "streams": streams,
            "host_syncs": syncs}


def run(emit, smoke: bool = False, device=None):
    """Packed against fp16 attention at B 4, S 4096 (512 with ``smoke``),
    H 8, D 128, GQ 4; then the ragged sweep and the backends."""
    from ..core.quant import dequantize_groups
    from ..kernels.decode_attn import decode_attn
    from ..kernels.ops import make_kernel_quant_fn

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=0,
                      n_sink=0)
    s_full = 512 if smoke else S
    q = torch.as_tensor(rng.normal(size=(B, H, GQ, D)), dtype=torch.float32,
                        device=dev)
    k, v = (torch.as_tensor(rng.normal(size=(B, s_full, H, D)),
                            dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    qf = make_kernel_quant_fn()
    k_qt = qf(k, pol.bits_k, pol.group_size, None, pol.fp8_meta)
    v_qt = qf(v, pol.bits_v, pol.group_size, None, pol.fp8_meta)
    mask = torch.ones((B, s_full), dtype=torch.float32, device=dev)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def packed():
        num, _, l = decode_attn(q, k_qt, v_qt, mask, pol, D, 1.0)
        return num / l

    with torch.no_grad():
        t_fp = _us(lambda: _fp16_attn(q, kt, vt), dev)
        t_q = _us(packed, dev)
        deq = [dequantize_groups(qt, D, bits, pol.group_size, pol.fp8_meta,
                                 torch.float32).transpose(1, 2)
               for qt, bits in ((k_qt, pol.bits_k), (v_qt, pol.bits_v))]
        err = float((packed() - _fp16_attn(q, *deq)).abs().max())
    planes = list(k_qt.values()) + list(v_qt.values())
    a16 = _nbytes(q, kt, vt)
    aq = _nbytes(q, mask, *planes)
    cache16 = 2 * B * s_full * H * D * 2
    cacheq = _nbytes(*planes)
    emit(C.csv_row("kernel_fp16_attn", t_fp,
                   f"occupancy=1.00,arg_bytes={a16},cache_bytes={cache16}"))
    emit(C.csv_row("kernel_packed_attn", t_q,
                   f"occupancy=1.00,arg_bytes={aq},cache_bytes={cacheq},"
                   f"cache_compression={cache16/cacheq:.2f}x,"
                   f"max_abs_err_vs_dequantized={err:.2e}"))
    emit(C.csv_row("kernel_hbm_win", 0.0,
                   f"operand_reduction={(a16)/(aq):.2f}x "
                   f"(the kernel reads packed bytes only)"))

    _bench_ragged_occupancy(emit, smoke, dev)
    _bench_decode_step_backends(emit, smoke, dev)
