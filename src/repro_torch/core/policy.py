"""Quantization policy (port of ``repro.core.policy``; DESIGN.md §8).

:class:`QuantPolicy` says how ONE layer's KV cache is quantized.  The port's
first slice runs a uniform policy on every layer: a bare policy is the whole
schedule.  ``PolicySchedule`` (per-layer bands) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

_ALLOWED_BITS = (1.0, 1.5, 2.0, 3.0, 4.0, 8.0, 16.0)


def bit_planes(bits: float) -> Tuple[Tuple[int, float], ...]:
    """Decompose a (possibly fractional) bit width into integer planes.

    Returns ((bits, fraction_of_groups), ...).  1.5 -> ((2, .5), (1, .5));
    3.0 -> ((4, .5), (2, .5)) (byte-aligned packing only supports 1/2/4/8).
    """
    if bits == 1.5:
        return ((2, 0.5), (1, 0.5))
    if bits == 3.0:
        return ((4, 0.5), (2, 0.5))
    b = int(bits)
    if b != bits or b not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported bits {bits}")
    return ((b, 1.0),)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """How to quantize ONE layer's KV cache (DESIGN.md §1–§3)."""

    bits_k: float = 2.0
    bits_v: float = 2.0
    group_size: int = 128          # channels per quant group (within head_dim)
    window: int = 128              # fp sliding-window length (0 = no window)
    n_sink: int = 5                # attention-sink tokens kept fp forever
    fp8_meta: bool = True          # store scale/zero in FP8-E4M3 (else fp16)
    clip: bool = True              # use calibrated per-group clip alpha
    reorder: bool = True           # use calibrated per-head channel permutation
    meta_dtype_bits: int = dataclasses.field(init=False, default=8)

    def __post_init__(self):
        if self.bits_k not in _ALLOWED_BITS or self.bits_v not in _ALLOWED_BITS:
            raise ValueError(f"bits must be in {_ALLOWED_BITS}")
        if self.group_size <= 0:
            raise ValueError("group_size must be positive")
        if self.bits_k >= 16 and self.bits_v >= 16 and \
                (self.window > 0 or self.n_sink > 0):
            raise ValueError(
                f"window ({self.window}) / n_sink ({self.n_sink}) are "
                f"meaningless on an fp16 policy; use window=0, n_sink=0")
        object.__setattr__(self, "meta_dtype_bits", 8 if self.fp8_meta else 16)

    @property
    def is_fp16(self) -> bool:
        return self.bits_k >= 16 and self.bits_v >= 16


FP16_POLICY = QuantPolicy(bits_k=16.0, bits_v=16.0, clip=False, reorder=False,
                          window=0, n_sink=0)
# The paper's headline configuration (Sec. 4.2, Fig. 4): K2 V1.5, g128, w128.
PAPER_POLICY = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=128,
                           n_sink=5, fp8_meta=True)


def as_layer_policy(policy) -> QuantPolicy:
    """Coerce to a single-layer :class:`QuantPolicy` (DESIGN.md §8).

    The port runs uniform policies only, so a bare policy is accepted and
    anything else is refused until per-layer schedules are ported."""
    if isinstance(policy, QuantPolicy):
        return policy
    raise TypeError(f"expected QuantPolicy (per-layer schedules are not "
                    f"ported yet), got {type(policy).__name__}")
