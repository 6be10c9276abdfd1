"""The paper's speed and memory claims on the card (counterpart of the
JAX repo's ``benchmarks/`` speed suites): :mod:`.memory_latency` (Table 6
and Appendix 9, analytic on the H100's constants and measured up to a
1,048,576-token llama2-7b context), :mod:`.kernel_bench` (the kernels and
the decode path), :mod:`.serving_bench` (the serving and chaos suites),
and the shared row format and timer (:mod:`.common`).  ``python -m
repro_torch.speed`` runs them.
"""
