"""SKVQ written out plainly in f32 (paper Sec. 3): clipped dynamic group
quantization of each cached token, and attention over a cache whose
older tokens are quantized while the sinks and the sliding window stay in
full precision.  Plain PyTorch; it imports nothing of the program.

Quantization, per token and head, per group of channels of each plane:
``lo = min``, ``hi = max`` (identity calibration: no clip, no reorder),
``h = max((hi - lo) / (2^b - 1), 1e-8)``, ``h`` and ``lo`` rounded through
fp8 E4M3 (saturating at 448), ``q = clamp(round_half_even((x - lo) / h),
0, 2^b - 1)``, read back as ``q * h + lo``.  A fractional width is two
planes: 1.5 bits is half the channels at 2 bits and half at 1.

Which key a query sees quantized: after a prefill the cache holds the
first ``n_sink`` tokens and the last ``window`` in full precision and the
rest quantized; each decode step appends its token to the window and the
token it pushes out is quantized.  So a query at position ``p`` that is
decoded (``p >= qstart``) reads key ``j`` quantized when ``n_sink <= j <
p + 1 - window``; a query inside the prompt (``p < qstart``) reads every
key in full precision, as the prefill attends before it quantizes."""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _planes(d: int, bits: float, group: int):
    split = {1.5: (2, 1), 3.0: (4, 2)}
    if bits in split:
        hi = max(int(d * 0.5) - int(d * 0.5) % 8, 8)
        b_hi, b_lo = split[bits]
        return [(0, hi, b_hi, min(group, hi)),
                (hi, d - hi, b_lo, min(group, d - hi))]
    return [(0, d, int(bits), min(group, d))]


def _meta(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    return x.clamp(-6.5e4, 6.5e4).half().float()


def fake_quant(x: torch.Tensor, bits: float, group: int,
               fp8_meta: bool = True) -> torch.Tensor:
    """Quantize and read back the last axis of ``x`` (any float), in f32."""
    x = x.float()
    out = torch.empty_like(x)
    for start, width, b, g in _planes(x.shape[-1], bits, group):
        xs = x[..., start:start + width]
        xg = xs.reshape(*xs.shape[:-1], width // g, g)
        lo = xg.amin(dim=-1)
        hi = xg.amax(dim=-1)
        h = ((hi - lo) / torch.full_like(hi, 2 ** b - 1)).clamp_min(1e-8)
        h, lo = _meta(h, fp8_meta), _meta(lo, fp8_meta)
        q = torch.round((xg - lo[..., None]) / h[..., None])
        q = torch.nan_to_num(q, nan=0.0).clamp(0, 2 ** b - 1)
        out[..., start:start + width] = (q * h[..., None] + lo[..., None]
                                         ).reshape(xs.shape)
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p0: int,
           qstart: int, policy: dict, scale: float,
           block: int = 32) -> torch.Tensor:
    """Causal attention of one sequence's queries over its SKVQ cache.

    q (T, Hq, D) at positions ``p0 .. p0 + T - 1``; k, v (S, Hkv, D) the
    full-precision keys and values of positions ``0 .. S - 1`` (S = p0 +
    T).  Returns (T, Hq, D) f32."""
    t, hq, d = q.shape
    s, hkv, _ = k.shape
    grp = hq // hkv
    kf, vf = k.float(), v.float()
    gs = policy["group_size"]
    kq = fake_quant(kf, policy["bits_k"], gs, policy["fp8_meta"])
    vq = fake_quant(vf, policy["bits_v"], gs, policy["fp8_meta"])
    ns, w = policy["n_sink"], policy["window"]
    j = torch.arange(s, device=q.device)
    out = torch.empty((t, hq, d), dtype=torch.float32, device=q.device)
    # (Hkv, S, D) operands for the grouped products
    kf_, vf_, kq_, vq_ = (x.permute(1, 0, 2) for x in (kf, vf, kq, vq))
    for a in range(0, t, block):
        b = min(t, a + block)
        p = torch.arange(p0 + a, p0 + b, device=q.device)
        qb = q[a:b].float().reshape(b - a, hkv, grp, d).permute(1, 2, 0, 3)
        qb = qb.reshape(hkv, grp * (b - a), d)
        sf = (qb @ kf_.transpose(1, 2)) * scale     # (Hkv, G*Tb, S)
        sq = (qb @ kq_.transpose(1, 2)) * scale
        use_q = ((p[:, None] >= qstart) & (j[None] >= ns) &
                 (j[None] < p[:, None] + 1 - w))    # (Tb, S)
        causal = j[None] <= p[:, None]
        use_q = use_q.repeat(grp, 1)[None]
        causal = causal.repeat(grp, 1)[None]
        sc = torch.where(use_q, sq, sf).masked_fill(~causal, -math.inf)
        pr = torch.softmax(sc, dim=-1)
        o = (torch.where(use_q, pr, 0.0) @ vq_ +
             torch.where(use_q, 0.0, pr) @ vf_)    # (Hkv, G*Tb, D)
        out[a:b] = o.reshape(hkv, grp, b - a, d).permute(2, 0, 1, 3) \
            .reshape(b - a, hq, d)
    return out
