"""Bit-packing of integer codes along the last axis (port of
``repro.core.packing``).

Little-endian within a byte: code ``i`` of a byte sits at bits
``[i*b, (i+1)*b)``.  Widths 1, 2, 4 and 8 (8 is the identity).
"""
from __future__ import annotations

import torch

SUPPORTED_BITS = (1, 2, 4, 8)


def codes_per_byte(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported bit width {bits}; want one of "
                         f"{SUPPORTED_BITS}")
    return 8 // bits


def packed_width(n: int, bits: int) -> int:
    """Bytes needed to pack ``n`` codes of ``bits`` width."""
    cpb = codes_per_byte(bits)
    if n % cpb != 0:
        raise ValueError(f"channel count {n} not divisible by codes/byte {cpb}")
    return n // cpb


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N) codes < 2**bits -> (..., N*bits/8) uint8."""
    cpb = codes_per_byte(bits)
    c = codes.to(torch.uint8)
    if bits == 8:
        return c
    *lead, n = c.shape
    c = c.reshape(*lead, packed_width(n, bits), cpb)
    out = c[..., 0].clone()
    for i in range(1, cpb):
        out |= c[..., i] << (i * bits)
    return out


def unpack_u8(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack`, staying in uint8."""
    cpb = codes_per_byte(bits)
    if bits == 8:
        return packed
    *lead, w = packed.shape
    mask = (1 << bits) - 1
    parts = [(packed >> (i * bits)) & mask for i in range(cpb)]
    return torch.stack(parts, dim=-1).reshape(*lead, w * cpb)
