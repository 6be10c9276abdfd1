"""Clipped dynamic group quantization (port of ``repro.core.quant``; paper
Sec. 3.1, Eq. 2; DESIGN.md §2–§3).

Per token, per group of the (reordered) channel axis:

    lo = alpha * min(x_g),  hi = alpha * max(x_g)
    h  = max((hi - lo) / (2^N - 1), 1e-8), then h and lo rounded through
         their storage dtype (FP8-E4M3 or fp16)
    q  = clamp(round_half_even((x - lo) / h), 0, 2^N - 1)

Fractional widths (V1.5) are two byte-aligned planes.  The codes, scale and
zero bytes are held bit-exact against the JAX reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .fp8 import quantize_meta, encode_fp8, decode_fp8
from .packing import pack, unpack_u8
from .policy import bit_planes

QTensor = Dict[str, torch.Tensor]
_EPS = 1e-8


def plane_layout(d: int, bits: float, group_size: int
                 ) -> List[Tuple[int, int, int, int]]:
    """[(channel_start, width, bits, group_size_effective), ...] per plane."""
    planes = bit_planes(bits)
    if len(planes) == 1:
        return [(0, d, planes[0][0], min(group_size, d))]
    (b_hi, frac), (b_lo, _) = planes
    d_hi = int(d * frac)
    d_hi -= d_hi % 8          # keep both planes packable (multiple of 8)
    d_hi = max(d_hi, 8)
    return [(0, d_hi, b_hi, min(group_size, d_hi)),
            (d_hi, d - d_hi, b_lo, min(group_size, d - d_hi))]


def n_meta_groups(d: int, bits: float, group_size: int) -> int:
    """Total scale/zero entries per token-head across all planes."""
    return sum(w // gs for (_, w, _, gs) in plane_layout(d, bits, group_size))


def _quant_plane(x: torch.Tensor, bits: int, gs: int, alpha,
                 fp8_meta: bool):
    """x (..., Dp) -> packed codes (..., Dp*bits/8) u8, scale/zero (..., Gp)."""
    *lead, dp = x.shape
    g = dp // gs
    xg = x.reshape(*lead, g, gs).to(torch.float32)
    lo = xg.amin(dim=-1)
    hi = xg.amax(dim=-1)
    if alpha is not None:
        lo = lo * alpha
        hi = hi * alpha
    # divide by a tensor, not a Python number: on CUDA torch turns division
    # by a host scalar into multiplication by its reciprocal, which is not
    # correctly rounded and breaks byte parity where h lands on an fp8 tie
    h = (hi - lo) / torch.full_like(hi, 2 ** bits - 1)
    h = h.clamp_min(_EPS)
    # metadata goes through its storage dtype BEFORE the codes are computed,
    # so dequant(quant(x)) is exactly what the decode kernel reproduces
    h = quantize_meta(h, fp8_meta)
    lo = quantize_meta(lo, fp8_meta)
    q = torch.round((xg - lo[..., None]) / h[..., None]).clamp(0, 2 ** bits - 1)
    # A group whose step rounds to 0 in its storage dtype divides 0/0 = NaN
    # for the element equal to lo.  The reference maps NaN to code 0 (XLA's
    # float->uint8 cast); torch's NaN->uint8 cast differs between CPU and
    # CUDA, so the mapping is made explicit here.
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    codes = pack(q.to(torch.uint8).reshape(*lead, dp), bits)
    if fp8_meta:
        return codes, encode_fp8(h), encode_fp8(lo)
    return codes, h.to(torch.float16), lo.to(torch.float16)


def _dequant_plane(codes, scale, zero, bits: int, gs: int, fp8_meta: bool,
                   dtype):
    # arithmetic in the target dtype (bf16 on the serve path), as the
    # reference does; f32 callers get f32 arithmetic
    cdt = torch.promote_types(dtype, torch.bfloat16)
    q = unpack_u8(codes, bits).to(cdt)
    *lead, dp = q.shape
    g = dp // gs
    h = decode_fp8(scale, cdt) if fp8_meta else scale.to(cdt)
    lo = decode_fp8(zero, cdt) if fp8_meta else zero.to(cdt)
    xg = q.reshape(*lead, g, gs) * h[..., None] + lo[..., None]
    return xg.reshape(*lead, dp).to(dtype)


def _alpha_slice(alpha, g_off: int, gp: int):
    if alpha is None:
        return None
    if not torch.is_tensor(alpha) or alpha.ndim == 0:
        return alpha
    return alpha[..., g_off:g_off + gp]


def quantize_groups(x: torch.Tensor, bits: float, group_size: int,
                    alpha: Optional[torch.Tensor] = None,
                    fp8_meta: bool = True) -> QTensor:
    """Quantize the last axis of ``x``; alpha: scalar or (..., G_total).

    Returns codes_hi/scale_hi/zero_hi (+ *_lo for mixed widths)."""
    d = x.shape[-1]
    out: QTensor = {}
    g_off = 0
    for name, (start, width, b, gs) in zip(
            ("hi", "lo"), plane_layout(d, bits, group_size)):
        gp = width // gs
        codes, scale, zero = _quant_plane(x[..., start:start + width], b, gs,
                                          _alpha_slice(alpha, g_off, gp),
                                          fp8_meta)
        out[f"codes_{name}"] = codes
        out[f"scale_{name}"] = scale
        out[f"zero_{name}"] = zero
        g_off += gp
    return out


def dequantize_groups(qt: QTensor, d: int, bits: float, group_size: int,
                      fp8_meta: bool = True, dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_groups` up to quantization error."""
    parts = [_dequant_plane(qt[f"codes_{name}"], qt[f"scale_{name}"],
                            qt[f"zero_{name}"], b, gs, fp8_meta, dtype)
             for name, (_, _, b, gs) in zip(
                 ("hi", "lo"), plane_layout(d, bits, group_size))]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def packed_nbytes(d: int, bits: float, group_size: int, meta_bits: int) -> int:
    """Bytes per token-head of the packed representation (codes + meta)."""
    return sum(width * b // 8 + 2 * (width // gs) * meta_bits // 8
               for (_, width, b, gs) in plane_layout(d, bits, group_size))
