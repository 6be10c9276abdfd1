"""Selective SSM (Mamba-style) head, the parallel path of a hymba block
(port of ``repro.models.ssm``).

The diagonal recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t,    y_t = C_t · h_t + D * x_t

runs over the whole prompt as a log-depth scan in f32 (:func:`_ssm_scan`,
Hillis–Steele doubling: ceil(log2 S) passes of elementwise products over
the time axis, never a Python loop over the tokens), where the reference
runs ``jax.lax.associative_scan``; both are plain tensor code, not a
kernel.  The association order differs, so the two agree to f32
rounding, not bitwise.

Decode carries ``(conv, h)`` per slot in the layer's cache dict
(``ssm_conv`` (B, K-1, Di) in the compute dtype, ``ssm_h`` (B, Di, N) f32):
O(1) work a step.  :func:`ssm_decode` writes the new state **in place**
into the tensors it was given, so a captured decode step replays onto the
same addresses.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from ..distributed.sharding import logical, seq_whole
from ..device import resolve_device


def inner_dim(cfg: ArchConfig) -> int:
    """Di, the width of the mamba path."""
    return cfg.d_model * cfg.ssm_expand


def dt_rank(cfg: ArchConfig) -> int:
    """R, the rank of the dt projection."""
    return max(cfg.d_model // 16, 1)


def _conv_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, Di), w (K, Di): the sum over the K
    taps in the reference's order, zero-padded in front."""
    k, s = w.shape[0], x.shape[1]
    xs = F.pad(x, (0, 0, k - 1, 0))
    out = xs[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xs[:, i:i + s] * w[i]
    return out


def _ssm_scan(dtA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """``h_t = dtA_t * h_{t-1} + dBx_t`` along axis 1 (h_{-1} = 0), all
    steps at once: Hillis–Steele doubling, each pass combining every step
    with the one ``k`` earlier (``(a, b)_t <- (a_t a_{t-k}, a_t b_{t-k} +
    b_t)``), k = 1, 2, 4, ...  Both inputs (B, S, ...) f32 are overwritten
    (the caller's transients); one temporary of their size is live at a
    time.  Returns h, the same tensor as ``dBx``.  Under autograd
    (training) each pass builds new tensors instead, with the same
    arithmetic, since the backward pass needs every pass's inputs."""
    a, b = dtA, dBx
    s = a.shape[1]
    in_place = not (torch.is_grad_enabled()
                    and (a.requires_grad or b.requires_grad))
    k = 1
    while k < s:
        last = 2 * k >= s               # the last pass needs no new a
        # the right sides read the pre-pass values before the write
        if in_place:
            b[:, k:] = torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])
            if not last:
                a[:, k:] = a[:, k:] * a[:, :-k]
        else:
            b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:],
                                                   b[:, :-k])], dim=1)
            if not last:
                a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def _split_proj(xs: torch.Tensor, p, cfg: ArchConfig):
    """B, C and dt from the conv output: ``x_proj`` then the dt projection
    and its softplus."""
    n = cfg.ssm_state
    bc_dt = xs @ p["x_proj"]
    bmat, cmat, dt_low = torch.split(
        bc_dt, [n, n, bc_dt.shape[-1] - 2 * n], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"] + p["dt_bias"])
    return bmat, cmat, dt


def ssm_forward(x: torch.Tensor, p, cfg: ArchConfig,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D) over the whole sequence [, the decode
    state ``{"conv": (B, K-1, Di), "h": (B, Di, N) f32}``].  The conv
    state is the last K-1 conv inputs, zero rows in front where the prompt
    is shorter (the reference returns only the rows it has, and its decode
    then fails to broadcast; ROADMAP §3)."""
    xz = logical(seq_whole(x) @ p["in_proj"], "batch", "seq", "ff")
    xs_raw, z = xz.chunk(2, dim=-1)                           # (B, S, Di)
    xs = F.silu(_conv_causal(xs_raw, p["conv_w"]) + p["conv_b"])
    bmat, cmat, dt = _split_proj(xs, p, cfg)
    a = -torch.exp(p["a_log"].to(torch.float32))              # (Di, N)
    dtA = torch.exp(dt.to(torch.float32)[..., None] * a)      # (B, S, Di, N)
    dBx = ((dt * xs).to(torch.float32)[..., None]
           * bmat.to(torch.float32)[..., None, :])
    h = _ssm_scan(dtA, dBx)
    del dtA
    y = torch.einsum("bsdn,bsn->bsd", h, cmat.to(torch.float32))
    y = (y + p["d_skip"] * xs.to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    out = logical(y @ p["out_proj"], "batch", "seq", None)
    if not return_state:
        return out
    k, s = cfg.ssm_conv, x.shape[1]
    conv = F.pad(xs_raw, (0, 0, max(0, k - 1 - s), 0))[:, -(k - 1):]
    # copies: views would hold the whole (B, S, ...) transients alive
    return out, {"conv": conv.clone(), "h": h[:, -1].clone()}


def ssm_decode(x1: torch.Tensor, state: Dict[str, torch.Tensor], p,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x1 (B, 1, D) from ``state`` ``{conv: (B, K-1, Di), h:
    (B, Di, N) f32}``: returns (y (B, 1, D), state), the state's two
    tensors updated **in place** (``copy_``)."""
    xz = x1 @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)                               # (B, 1, Di)
    conv_in = torch.cat([state["conv"], xs.to(state["conv"].dtype)], dim=1)
    xs = F.silu((conv_in * p["conv_w"][None]).sum(dim=1, keepdim=True)
                + p["conv_b"])
    bmat, cmat, dt = _split_proj(xs, p, cfg)
    a = -torch.exp(p["a_log"].to(torch.float32))
    dtA = torch.exp(dt.to(torch.float32)[:, 0, :, None] * a)  # (B, Di, N)
    dBx = ((dt * xs).to(torch.float32)[:, 0, :, None]
           * bmat.to(torch.float32)[:, 0, None, :])
    h = dtA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, cmat.to(torch.float32)[:, 0])
    y = (y + p["d_skip"] * xs.to(torch.float32)[:, 0]).to(x1.dtype)[:, None]
    y = y * F.silu(z)
    state["conv"].copy_(conv_in[:, 1:])
    state["h"].copy_(h)
    return y @ p["out_proj"], state


def state_shapes(batch: int, cfg: ArchConfig, dtype=torch.float32):
    """``{"ssm_conv": (shape, dtype), "ssm_h": (shape, f32)}``: one layer's
    decode-state leaves of a cache dict."""
    di = inner_dim(cfg)
    return {"ssm_conv": ((batch, cfg.ssm_conv - 1, di), dtype),
            "ssm_h": ((batch, di, cfg.ssm_state), torch.float32)}


def init_ssm_state(batch: int, cfg: ArchConfig, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state ``{conv, h}`` (reference ``init_ssm_state``) on
    ``device`` (default CUDA; raises without a card unless ``"cpu"``)."""
    dev = resolve_device(device)
    shapes = state_shapes(batch, cfg, dtype)
    return {k[4:]: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in shapes.items()}
