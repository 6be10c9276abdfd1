"""granite-moe-1b-a400m [moe] — 24L d=1024 16H (kv 8) vocab=49155.
32 routed experts top-8, expert width 512, no shared experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155, rope_theta=10_000.0,
    n_experts=32, top_k=8, d_expert=512,
    mlp_act="silu", tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, n_experts=4, top_k=2, d_expert=32)
