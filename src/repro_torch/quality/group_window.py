"""Paper Table 4 (group size) + Figure 6 (window size) + Figure 4 / Table 2
(avg-bits frontier incl. K2V1.5) (port of ``benchmarks/group_window.py``).

One module, three sweeps, all on the shared bench model.
"""
from __future__ import annotations

from ..core.baselines import METHODS
from ..core.policy import QuantPolicy
from . import common as C


def run(emit, *, cache_dir=None, device=None):
    cfg, params, corpus = C.bench_model(cache_dir, device)
    toks = C.eval_tokens(corpus, device=device)

    def ppl(pol, calibs, method="skvq"):
        return C.ppl_with_method(params, cfg, toks, METHODS[method],
                                 calibs=calibs, policy=pol)

    def calib(pol):
        return C.calibrate(cfg, params, corpus, pol)

    # --- Table 4: group size sweep (K2V2, window 32) -----------------------
    t4 = {}
    for gs in (32, 16, 8):
        pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=gs, window=32,
                          n_sink=5)
        t4[gs] = ppl(pol, calib(pol))
        emit(C.row(f"table4_g{gs}", f"ppl={t4[gs]:.4f},"
                   f"avg_bits={pol.avg_bits(cfg.head_dim):.3f}"))
    emit(C.row("table4_finer_groups_help",
               f"holds={t4[8] <= t4[32] * 1.02}"))

    # --- Figure 6: window size sweep (K2V2 g32) ----------------------------
    f6 = {}
    pol0 = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=32,
                       n_sink=0)
    calibs = calib(pol0)
    for w in (0, 8, 16, 32, 64):
        pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=w,
                          n_sink=0)
        f6[w] = ppl(pol, calibs)
        emit(C.row(f"fig6_w{w}", f"ppl={f6[w]:.4f}"))
    emit(C.row("fig6_window_monotone", f"holds={f6[64] <= f6[0] * 1.01}"))

    # --- Figure 4 frontier: K2V2 vs K2V1.5 (+Table 2 RTN-sym reference) ----
    for name, bk, bv in (("k2v2", 2.0, 2.0), ("k2v1.5", 2.0, 1.5),
                         ("k4v4", 4.0, 4.0)):
        pol = QuantPolicy(bits_k=bk, bits_v=bv, group_size=32, window=32,
                          n_sink=5)
        p4 = ppl(pol, calib(pol))
        emit(C.row(f"fig4_{name}", f"ppl={p4:.4f},"
                   f"avg_bits={pol.avg_bits(cfg.head_dim):.3f}"))
    pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=0,
                      n_sink=0, clip=False, reorder=False)
    ppl_sym = ppl(pol, calib(pol), "rtn_sym")
    emit(C.row("table2_rtn_sym_2bit", f"ppl={ppl_sym:.4f}"))
    return {"table4": t4, "fig6": f6}
