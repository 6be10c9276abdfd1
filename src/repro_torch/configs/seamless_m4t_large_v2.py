"""seamless-m4t-large-v2 [audio] — enc-dec, 24L+24L d=1024 16H (MHA kv 16)
ff=8192 vocab=256206. Multimodal frontend STUBBED: encoder consumes
precomputed frame embeddings (B, S_enc, d). Decoder self-attn cache gets full
SKVQ; the static cross-attention cache is quantized once at prefill
(window degenerates to 0). Non-gated ReLU FFN + LayerNorm per the m4t stack.
[arXiv:2308.11596; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256_206, rope_theta=10_000.0,
    mlp_act="relu", mlp_gated=False, norm="layer", tie_embeddings=True,
    input_embeds=False, enc_seq_len=4096,
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, enc_seq_len=32)
