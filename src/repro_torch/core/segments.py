"""Index math + flash partials for the SKVQ segment layout (port of
``repro.core.segments``; DESIGN.md §1, §4).

Token order is ``[sinks, quantized, window]``.  ``length`` is per-slot
``(B,)`` (or a scalar); masks come out ``(B, T)`` for per-slot inputs and
``(T,)`` for scalars.  The ring slot of absolute token ``t`` is
``(t - n_sink) % window``.  Everything here stays on the tensors' device —
no helper reads a value back to the host.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

NEG = -1e30
_NO_WINDOW = 2 ** 30


def effective_window(window) -> int:
    """Local attention window: 0 (or None) means unlimited."""
    w = 0 if window is None else int(window)
    return w if w > 0 else _NO_WINDOW


def _t(x, device=None) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, device=device)


def _col(x: torch.Tensor) -> torch.Tensor:
    """() -> (1,), (B,) -> (B, 1)."""
    return x[..., None]


def bcast_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """(T,) or (B, T) -> (B, T)."""
    if x.ndim == 1:
        x = x[None]
    return x.expand(b, x.shape[-1])


def quantized_count(length, n_sink: int, window: int) -> torch.Tensor:
    """Number of tokens actually written to the packed region."""
    return (_t(length) - n_sink - window).clamp_min(0)


def sink_segment(n_sink: int, length) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions/stored-mask of the fp sink buffer (absolute [0, n_sink))."""
    length = _t(length)
    p = torch.arange(n_sink, dtype=torch.int32, device=length.device)
    return p, p < (_col(length) if length.ndim else length)


def packed_segment(j: torch.Tensor, length, n_sink: int, window: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions/stored-mask for packed-region slots ``j`` (u-indices)."""
    pos = (n_sink + j).to(torch.int32)
    qc = quantized_count(length, n_sink, window)
    return pos, j < (_col(qc) if qc.ndim else qc)


def window_segment(window: int, n_sink: int, length
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions/stored-mask of the fp ring buffer, slot-ordered: slot ``s``
    holds the newest token ``t`` with ``(t - n_sink) % window == s``."""
    length = _t(length)
    sl = torch.arange(window, dtype=torch.int32, device=length.device)
    lcol = length.reshape(-1)[:, None]
    u_last = lcol - 1 - n_sink
    u_s = u_last - torch.remainder(u_last - sl, window)
    pos = (u_s + n_sink).to(torch.int32)
    stored = (u_s >= 0) & (u_s > u_last - window) & (pos < lcol)
    if length.ndim == 0:
        pos, stored = pos[0], stored[0]
    return pos, stored


def block_live(ok: torch.Tensor, block_s: int) -> torch.Tensor:
    """(B, S) attendability -> (B, S // block_s) "block holds a live token"
    (the single source of decode block pruning; DESIGN.md §4)."""
    if ok.ndim == 1:
        ok = ok[None]
    b, s = ok.shape
    assert s % block_s == 0, (s, block_s)
    return ok.reshape(b, s // block_s, block_s).any(dim=-1)


def packed_block_bounds(ok: torch.Tensor, block_s: int) -> torch.Tensor:
    """Per-slot live block range ``[lo, hi)`` as (B, 2) int32; a slot with
    no attendable packed token gets ``lo == hi == 0`` (DESIGN.md §4)."""
    blk = block_live(ok, block_s).to(torch.uint8)
    nb = blk.shape[-1]
    has = blk.amax(dim=-1) > 0
    lo = torch.argmax(blk, dim=-1).to(torch.int32)
    hi = (nb - torch.argmax(blk.flip(-1), dim=-1)).to(torch.int32)
    zero = torch.zeros_like(lo)
    return torch.stack([torch.where(has, lo, zero),
                        torch.where(has, hi, zero)], dim=-1)


def blocks_visited(bounds: torch.Tensor) -> torch.Tensor:
    """Per-slot count of blocks the pruned decode walk visits (>= 1)."""
    return (bounds[..., 1] - bounds[..., 0]).clamp_min(1)


def attend_ok(pos, stored, t_now, window_eff) -> torch.Tensor:
    """Final attendability: stored ∧ causal ∧ inside the local band."""
    t_now = _t(t_now)
    dlt = (_col(t_now) if t_now.ndim else t_now) - pos
    return stored & (dlt >= 0) & (dlt < window_eff)


# --------------------------------------------------- flash-style partials

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping (identity when cap <= 0)."""
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def partial_attend(qg, keys, values, ok, scale, cap: float = 0.0):
    """Unnormalized attention over one segment.

    qg (B, Hkv, Gq, D); keys/values (B, T, Hkv, D); ok (T,) or (B, T).
    Returns (num (B,Hkv,Gq,D), m (B,Hkv,Gq), l (B,Hkv,Gq)) in f32."""
    k = keys.transpose(1, 2).to(torch.float32)
    v = values.transpose(1, 2).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.to(torch.float32) * scale, k)
    s = softcap(s, cap)
    okb = ok[None, None, None, :] if ok.ndim == 1 else ok[:, None, None, :]
    s = torch.where(okb, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhgt,bhtd->bhgd", p, v), m, p.sum(dim=-1)


def merge_partials(a, b):
    """Online-softmax merge of two (num, m, l) partials."""
    num_a, m_a, l_a = a
    num_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    return num_a * wa[..., None] + num_b * wb[..., None], m, l_a * wa + l_b * wb


def finalize(parts: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
             ) -> torch.Tensor:
    """Merge flash partials and normalize -> (B, Hkv, Gq, D)."""
    num, m, l = parts[0]
    for pt in parts[1:]:
        num, m, l = merge_partials((num, m, l), pt)
    return num / l.clamp_min(1e-30)[..., None]
