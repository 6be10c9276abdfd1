"""ArchConfig — declarative model description (port of
``repro.models.config``, the fields the dense family reads).

The port's transformer runs ``family="dense"`` only; the other families of
the reference (moe, hybrid, ssm, encdec, vlm) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # only "dense" runs in the port so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    query_scale: float = 0.0           # 0 -> 1/sqrt(head_dim)
    local_window: int = 0              # sliding-window size for "local" layers
    local_pattern: Tuple[int, ...] = ()
    # --- mlp ---
    mlp_act: str = "silu"              # silu | gelu | relu
    mlp_gated: bool = True
    tie_embeddings: bool = True
    embed_scale: bool = False
    norm_eps: float = 1e-6

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_is_local(self, i: int) -> bool:
        if not self.local_pattern:
            return False
        return bool(self.local_pattern[i % len(self.local_pattern)])

    def scaled(self, **kw) -> "ArchConfig":
        """Derive a reduced config (smoke tests) keeping the family wiring."""
        return dataclasses.replace(self, **kw)
