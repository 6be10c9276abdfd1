"""FP8 (E4M3) encode/decode for quantization metadata (port of
``repro.core.fp8``).

Metadata is stored as the raw uint8 bit pattern.  Encoding saturates at
±448 first: E4M3 has no infinity, so an out-of-range value would otherwise
become NaN.  torch's ``float8_e4m3fn`` cast rounds to nearest even, as
jax's does.
"""
from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0
FP16_META_MAX = 6.5e4


def encode_fp8(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 bit pattern of E4M3 (saturating at ±448)."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(E4M3).view(torch.uint8)


def decode_fp8(u: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 bit pattern of E4M3 -> float."""
    return u.view(E4M3).to(dtype)


def quantize_meta(x: torch.Tensor, use_fp8: bool,
                  dtype=torch.float32) -> torch.Tensor:
    """Round metadata through its storage dtype (fp8, or fp16 clipped to
    ±6.5e4)."""
    if use_fp8:
        return decode_fp8(encode_fp8(x), dtype)
    return x.clamp(-FP16_META_MAX, FP16_META_MAX).to(torch.float16).to(dtype)
