"""Paper Table 3: component ladder — RTN -> +window -> +clip -> +reorder ->
+sink -> +FP8 (K2V2 g16, mirroring the paper's ablation setting), extended
one rung past the paper with a per-layer schedule component (+fp16_guard:
first layer uncompressed, DESIGN.md §8) (port of
``benchmarks/component_ablation.py``)."""
from __future__ import annotations

from typing import Callable, Optional

from ..core.baselines import _apply_perm
from ..core.calibrate import resolve_quant_fn
from ..core.policy import PolicySchedule, QuantPolicy, fp16_guard
from ..core.quant import fake_quant
from ..core.reorder import invert_permutation, on_device
from . import common as C


def _staged(stage):
    """Returns a method fn implementing the cumulative ladder up to `stage`.
    It quantizes through ``ctx.quant_fn`` as the baselines do (the bulk
    kernel on the card), never ``fake_quant``'s plain default."""

    def method(k, v, ctx):
        p = ctx.policy
        c = ctx.calib
        qf = resolve_quant_fn(ctx.quant_fn, k.device)
        use_reorder = stage >= 3
        use_clip = stage >= 2
        kk, vv = k, v
        if use_reorder:
            kk = _apply_perm(kk, c.perm_k)
            vv = _apply_perm(vv, c.perm_v)
        ak = on_device(c.alpha_k, k.device) if use_clip else None
        av = on_device(c.alpha_v, v.device) if use_clip else None
        fp8 = stage >= 5
        kq = fake_quant(kk, p.bits_k, p.group_size, alpha=ak, fp8_meta=fp8,
                        quant_fn=qf)
        vq = fake_quant(vv, p.bits_v, p.group_size, alpha=av, fp8_meta=fp8,
                        quant_fn=qf)
        if use_reorder:
            kq = _apply_perm(kq, invert_permutation(c.perm_k))
            vq = _apply_perm(vq, invert_permutation(c.perm_v))
        return kq, vq

    return method


STAGES = ["rtn", "+window", "+clip", "+reorder", "+sink", "+fp8"]


def run(emit, *, cache_dir=None, device=None,
        quant_fn: Optional[Callable] = None):
    cfg, params, corpus = C.bench_model(cache_dir, device)
    toks = C.eval_tokens(corpus, device=device)
    base = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=16, window=32,
                       n_sink=5, fp8_meta=False)
    calibs = C.calibrate(cfg, params, corpus, base, quant_fn=quant_fn)
    rows = {}
    for i, name in enumerate(STAGES):
        pol = QuantPolicy(
            bits_k=2.0, bits_v=2.0, group_size=16,
            window=32 if i >= 1 else 0,
            n_sink=5 if i >= 4 else 0,
            fp8_meta=i >= 5)
        ppl = C.ppl_with_method(params, cfg, toks, _staged(i),
                                calibs=calibs, policy=pol, quant_fn=quant_fn)
        rows[name] = ppl
        emit(C.row(f"table3_{name}", f"ppl={ppl:.4f}"))
    # one rung past the paper: per-layer scheduling as a component — the
    # full SKVQ policy everywhere except an fp16 guard first layer
    full = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=16, window=32,
                       n_sink=5, fp8_meta=True)
    sched = PolicySchedule((fp16_guard(full),) + (full,) * (cfg.n_layers - 1))
    ppl = C.ppl_with_schedule(params, cfg, toks, sched, calibs=calibs,
                              quant_fn=quant_fn)
    rows["+fp16_guard"] = ppl
    emit(C.row(
        "table3_+fp16_guard",
        f"ppl={ppl:.4f},avg_bits={sched.avg_bits(cfg.head_dim):.3f},"
        f"layer_bits={C.bits_breakdown(sched, cfg.head_dim)}"))
    # directionality: window + reorder are the big wins (paper Table 3)
    emit(C.row("table3_window_helps",
               f"holds={rows['+window'] < rows['rtn']}"))
    emit(C.row("table3_reorder_helps",
               f"holds={rows['+reorder'] <= rows['+clip'] * 1.02}"))
    emit(C.row("table3_guard_helps",
               f"holds={rows['+fp16_guard'] <= rows['+fp8'] * 1.02}"))
    return rows
