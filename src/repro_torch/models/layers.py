"""Shared neural layers as plain functions over param dicts (port of
``repro.models.layers``).  Weights are ``(d_in, d_out)``, applied ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMS norm in f32 with the reference's ``(1 + w)`` gain."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
    return x


_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim//2) in f32."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), -idx / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2) — rotate-half form."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(x: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """Gated (or plain) MLP: act(x @ wi_gate) * (x @ wi_up) @ wo."""
    a = _ACTS[cfg.mlp_act]
    if cfg.mlp_gated:
        h = a(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = a(x @ p["wi_up"])
    return h @ p["wo"]


def embed(tokens: torch.Tensor, emb: torch.Tensor, scale: bool):
    x = emb[tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(emb.shape[1]), dtype=x.dtype)
    return x


def unembed(x: torch.Tensor, params, cfg: ArchConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ w.to(x.dtype), cfg.logit_softcap)
