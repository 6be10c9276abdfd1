"""deepseek-moe-16b [moe] — 28L d=2048 16H (MHA kv 16) vocab=102400.
Fine-grained MoE: 64 routed experts top-6 + 2 shared experts, expert width
1408; first layer dense (ff 10944). [arXiv:2401.06066; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,                      # dense (first) layer FFN width
    vocab_size=102_400, rope_theta=10_000.0,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408, first_dense=1,
    mlp_act="silu", tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, n_experts=8, top_k=2, n_shared_experts=1,
    d_expert=32, first_dense=1)
