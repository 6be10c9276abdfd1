"""ArchConfig — declarative model description (port of
``repro.models.config``, the fields the ported families read).

The port's transformer runs these families:

  dense   — pre-norm decoder (llama, granite, the gemma local/global stacks)
  vlm     — dense decoder with M-RoPE and an embedding input (qwen2-vl; the
            vision frontend stubbed as in the reference)
  moe     — dense attention + routed-expert FFN after ``first_dense`` dense
            layers (deepseek-moe, granite-moe)
  hybrid  — parallel attention + Mamba heads per block (hymba)
  ssm     — attention-free RWKV6 (Finch): no KV cache, an O(1) recurrent
            state a layer
  encdec  — encoder-decoder with a cross-attention cache (seamless-m4t
            backbone; the speech frontend stubbed: the encoder reads frame
            embeddings)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | vlm | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0     # gemma3: local layers use a different base
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE half-dim sections
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    query_scale: float = 0.0           # 0 -> 1/sqrt(head_dim)
    local_window: int = 0              # sliding-window size for "local" layers
    local_pattern: Tuple[int, ...] = ()
    qk_norm: bool = False              # gemma3 RMS-norms q and k
    qkv_bias: bool = False             # qwen2
    # --- mlp ---
    mlp_act: str = "silu"              # silu | gelu | relu
    mlp_gated: bool = True
    tie_embeddings: bool = True
    embed_scale: bool = False
    norm: str = "rms"                  # rms | layer
    norm_eps: float = 1e-6
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0                  # per-expert FFN width
    first_dense: int = 0               # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"      # grouped (GShard-style) | scatter
    # --- ssm / hybrid ---
    ssm_state: int = 0                 # Mamba state size (hymba)
    ssm_conv: int = 4                  # depthwise causal conv width
    ssm_expand: int = 1                # inner expansion of the mamba path
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    # --- enc-dec ---
    n_enc_layers: int = 0
    enc_seq_len: int = 4096            # stub frontend frames for decode cells
    # --- io stubs ---
    input_embeds: bool = False         # vlm: inputs may be embeddings
    # --- training ---
    remat: bool = False                # activation-checkpoint each block
    remat_policy: str = "nothing"      # nothing (full remat) | dots | none

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def layer_is_local(self, i: int) -> bool:
        if not self.local_pattern:
            return False
        return bool(self.local_pattern[i % len(self.local_pattern)])

    def scaled(self, **kw) -> "ArchConfig":
        """Derive a reduced config (smoke tests) keeping the family wiring."""
        return dataclasses.replace(self, **kw)
