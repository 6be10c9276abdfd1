"""Paper Table 1 / Table 5: method comparison (FP16/RTN/SmoothQuant/RPTQ/KIVI/
SKVQ) at K2V2 g128-equivalent, window 128-equivalent — scaled to the bench
model (g16, w32) (port of ``benchmarks/quality_ladder.py``).  Metric:
synthetic-corpus PPL with position-correct window semantics (LongBench
stand-in; see :mod:`.common`).

The sweep also covers per-layer :class:`PolicySchedule`\\ s (DESIGN.md §8):
the uniform schedule must reproduce the SKVQ method row exactly, and the
mixed rows (fp16 guard layer, bits ladder) report ppl next to their
schedule-weighted avg-bits so quality-per-byte is readable from the rows."""
from __future__ import annotations

from typing import Callable, Optional

from ..core.baselines import METHODS
from ..core.policy import PolicySchedule, QuantPolicy, fp16_guard
from . import common as C

ORDER = ("fp16", "rtn", "smoothquant", "rptq", "kivi", "skvq")


def run(emit, *, cache_dir=None, device=None,
        quant_fn: Optional[Callable] = None):
    cfg, params, corpus = C.bench_model(cache_dir, device)
    toks = C.eval_tokens(corpus, device=device)
    pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=16, window=32,
                      n_sink=5)
    calibs = C.calibrate(cfg, params, corpus, pol, quant_fn=quant_fn)
    rows = {}
    for name in ORDER:
        ppl = C.ppl_with_method(params, cfg, toks, METHODS[name],
                                calibs=calibs, policy=pol, quant_fn=quant_fn)
        rows[name] = ppl
        emit(C.row(f"table1_{name}", f"ppl={ppl:.4f}"))
    # the paper's ordering claim
    ok = rows["skvq"] <= min(rows["rptq"], rows["kivi"],
                             rows["smoothquant"], rows["rtn"]) * 1.02
    emit(C.row("table1_skvq_best_of_quantized", f"holds={ok}"))

    # --- per-layer schedule sweep (DESIGN.md §8) -------------------------
    n = cfg.n_layers
    scheds = {
        "uniform": PolicySchedule.uniform(pol, n),
        "guard_first_fp16": PolicySchedule((fp16_guard(pol),)
                                           + (pol,) * (n - 1)),
        "ladder_k4_first": PolicySchedule.bits_ladder(
            pol, ((4.0, 4.0),) + ((2.0, 2.0),) * (n - 1), n),
    }
    for name, sched in scheds.items():
        # mixed schedules need per-layer calibration (alpha grid search is
        # bit-width-dependent); the uniform row reuses the method calibs so
        # the matches-skvq regression below compares identical artifacts
        cl = calibs if sched.is_uniform else C.calibrate_schedule(
            cfg, params, corpus, sched, quant_fn=quant_fn)
        ppl = C.ppl_with_schedule(params, cfg, toks, sched, calibs=cl,
                                  quant_fn=quant_fn)
        rows[f"sched_{name}"] = ppl
        emit(C.row(
            f"table1_sched_{name}",
            f"ppl={ppl:.4f},avg_bits={sched.avg_bits(cfg.head_dim):.3f},"
            f"layer_bits={C.bits_breakdown(sched, cfg.head_dim)}"))
    # regression: the uniform schedule is the SKVQ method, exactly
    same = abs(rows["sched_uniform"] - rows["skvq"]) < 1e-6
    emit(C.row("table1_sched_uniform_matches_skvq", f"holds={same}"))
    return rows
