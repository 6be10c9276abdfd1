"""rwkv6-3b "Finch" [ssm] — 32L d=2560 (attention-free) ff=8960 vocab=65536.
Data-dependent decay, head_dim 64 (40 wkv heads). NO KV cache exists, so SKVQ
is inapplicable (DESIGN.md §Arch-applicability) — the arch runs without it;
decode state is O(1) in context length.
[arXiv:2404.05892; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65_536,
    rwkv_head_dim=64, rwkv_lora_rank=32,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, rwkv_head_dim=16, rwkv_lora_rank=8)
