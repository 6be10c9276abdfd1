"""qwen2-vl-7b [vlm] — 28L d=3584 28H (kv 4) ff=18944 vocab=152064.
M-RoPE (temporal/height/width sections 16/24/24 of the 64 half-dims), qkv bias,
dynamic-resolution vision frontend STUBBED: the entry points take precomputed
patch embeddings (``embeds=``) and 3D positions (``positions=``).
[arXiv:2409.12191; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152_064, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), qkv_bias=True,
    mlp_act="silu", tie_embeddings=False, input_embeds=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3))
