"""granite-8b [dense] — 36L d=4096 32H (kv 8) ff=14336 vocab=49152, llama-arch
code model. [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, rope_theta=10_000_000.0,
    mlp_act="silu", tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256)
