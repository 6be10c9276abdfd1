"""llama2-7b [dense] — the paper's own primary evaluation family (Table 1).
32L d=4096 32H MHA ff=11008 vocab=32000. [arXiv:2307.09288]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32_000, rope_theta=10_000.0,
    mlp_act="silu", tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256)
