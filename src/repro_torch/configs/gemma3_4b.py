"""gemma3-4b [dense] — 34L d=2560 8H (kv 4) ff=10240 vocab=262144.
5:1 local:global (1024-token local window), qk-norm, dual rope bases
(local 10k / global 1M), 128k context. [hf:google/gemma-3-*-pt; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262_144,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    local_window=1024, local_pattern=(1, 1, 1, 1, 1, 0),
    qk_norm=True, mlp_act="gelu", tie_embeddings=True, embed_scale=True,
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, local_window=8)
