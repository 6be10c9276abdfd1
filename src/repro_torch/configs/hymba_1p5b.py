"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv 5, head_dim 64) ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads per block.
Hymba's meta-tokens map onto SKVQ attention sinks (DESIGN.md); 3 full-attention
layers (first/middle/last), the rest sliding-window 1024.
[arXiv:2411.13676; hf]"""
from ..models.config import ArchConfig

_L = 32
_pattern = tuple(0 if i in (0, _L // 2, _L - 1) else 1 for i in range(_L))

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=_L, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001, rope_theta=10_000.0,
    local_window=1024, local_pattern=_pattern,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    mlp_act="silu", tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, local_window=8,
    local_pattern=(0, 1, 1), ssm_state=4, ssm_expand=2)
