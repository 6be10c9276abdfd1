"""Smoke sizes of the benchmark's cells for the CPU tests: every width cut
down, the same code paths, the kernels' plain versions."""

POLICY = {"bits_k": 2.0, "bits_v": 1.5, "group_size": 16, "window": 8,
          "n_sink": 2, "fp8_meta": True}
DENSE = {"num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "intermediate_size": 128, "vocab_size": 256, "policy": POLICY}
MOE = dict(DENSE, num_hidden_layers=3, num_key_value_heads=4,
           n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
           moe_intermediate_size=32, first_k_dense_replace=1,
           capacity_factor=4.01)
DECODE = {"slots": 3, "context": 40, "round_tokens": 8, "steps_per_sync": 4,
          "check_tokens": 6}
CELLS = {"granite8b.long_decode": (DENSE, DECODE),
         "dsmoe16b.batch_decode": (MOE, DECODE)}


def overrides(workload: str) -> dict:
    cfg, traffic = CELLS[workload]
    return {"config": cfg, "traffic": traffic}
