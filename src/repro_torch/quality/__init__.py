"""The paper's quality evaluation in the port (counterpart of the JAX
repo's ``benchmarks/`` quality studies): the position-correct proxy
perplexity and per-layer calibration (:mod:`.common`), and one module per
table or figure — :mod:`.quality_ladder` (Tables 1/5, the schedule sweep),
:mod:`.component_ablation` (Table 3), :mod:`.group_window` (Table 4, Figs
4 and 6, Table 2), :mod:`.needle_proxy` (Figs 5/7) and
:mod:`.schedule_quality`.  ``python -m repro_torch.quality`` runs them.
"""
