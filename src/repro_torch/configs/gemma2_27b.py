"""gemma2-27b [dense] — 46L d=4608 32H (kv 16) ff=36864 vocab=256000.
Local:global 1:1 alternation (4096 local window), attn softcap 50, final logit
softcap 30, query scale 1/sqrt(d_model/n_heads)=1/12. [arXiv:2408.00118; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256_000, rope_theta=10_000.0,
    attn_softcap=50.0, logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    local_window=4096, local_pattern=(1, 0),
    mlp_act="gelu", tie_embeddings=True, embed_scale=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, local_window=8, query_scale=(64 / 4) ** -0.5)
