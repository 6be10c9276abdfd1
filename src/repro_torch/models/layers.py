"""Shared neural layers as plain functions over param dicts (port of
``repro.models.layers``).  Weights are ``(d_in, d_out)``, applied ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from ..distributed.sharding import logical, seq_whole


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMS norm in f32 with the reference's ``(1 + w)`` gain."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6):
    """LayerNorm with f32 statistics (mean, biased variance) and the
    reference's eps, not torch's default."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def norm(x: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """The config's block norm over a ``{"w"[, "b"]}`` param dict: LayerNorm
    for ``norm="layer"``, else the ``(1 + w)`` RMS norm."""
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
    return x


_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def act_fn(name: str):
    return _ACTS[name]


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim//2) in f32; nothing
    here copies from the host."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    # an on-device fill, not a host tensor: no host-to-device copy, so the
    # decode step stays capturable in a CUDA graph (the same f32 value)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=positions.device), -idx / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: ``positions3`` (3, B, S); ``sections`` are half-dim
    widths summing to ``head_dim // 2``.  Each frequency band takes its
    angle from the (temporal | height | width) position stream it belongs
    to.  The band picks are built on the device from the static sections
    (no host tensor), so a captured decode step may hold them."""
    half = head_dim // 2
    dev = positions3.device
    idx = torch.arange(0, half, dtype=torch.float32, device=dev)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32, device=dev),
                     -idx / half)
    ang = positions3.to(torch.float32)[..., None] * freq   # (3, B, S, half)
    edges = [0]
    for w in sections:
        edges.append(edges[-1] + w)
    pick = torch.stack([((idx >= lo) & (idx < hi)).to(torch.float32)
                        for lo, hi in zip(edges[:-1], edges[1:])])
    ang = (ang * pick[:, None, None, :]).sum(dim=0)        # (B, S, half)
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
    a = act_fn(cfg.mlp_act)
    x = seq_whole(x)
    if cfg.mlp_gated:
        g = logical(x @ p["wi_gate"], "batch", "seq", "ff")
        u = logical(x @ p["wi_up"], "batch", "seq", "ff")
        h = a(g) * u
    else:
        h = a(logical(x @ p["wi_up"], "batch", "seq", "ff"))
    return logical(h @ p["wo"], "batch", "seq", None)


def embed(tokens: torch.Tensor, emb: torch.Tensor, scale: bool):
    """The rows of ``emb`` at ``tokens`` (``F.embedding``: its backward
    sums repeated tokens in a fixed order, where indexing's accumulating
    backward does not on the CPU, so a train step repeats bitwise)."""
    # on a mesh the lookup reads whole rows: the table is gathered over
    # its vocab shards (DTensor cannot carry a vocab-sharded lookup's
    # masked partial sums back through the backward pass)
    x = F.embedding(tokens.long(), logical(emb, None, None))
    if scale:
        x = x * torch.tensor(math.sqrt(emb.shape[1]), dtype=x.dtype)
    return x


def unembed(x: torch.Tensor, params, cfg: ArchConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = logical(seq_whole(x) @ w.to(x.dtype), "batch", "seq", "vocab")
    return softcap(logits, cfg.logit_softcap)
