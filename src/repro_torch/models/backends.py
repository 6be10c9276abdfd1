"""Pluggable decode-attention backends (port of ``repro.models.backends``;
DESIGN.md §4).

A backend answers "given a query token and the SKVQ cache, what is the
attention output?" and supplies the quantizer for tokens sliding out of the
fp window, so attention and quantization agree on the packed layout.

* ``"reference"`` — dequantize in the compute dtype, attend with the shared
  flash partials (``attention.decode_attention_skvq``); quantizes with
  ``core.quant.quantize_groups``.  The default off the card.
* ``"cuda"`` — the ``decode_attn`` kernel over the packed planes
  (``kernels.ops.cuda_decode_attention``), and ALWAYS the ``kv_quant``
  kernel as its quantizer, so both kernels are on the main path.  The
  counterpart of the reference's ``PallasBackend``; the default on a CUDA
  device.  On CPU tensors both kernels run their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from .config import ArchConfig
from ..core.policy import QuantPolicy, as_layer_policy

_REGISTRY: Dict[str, Callable[..., object]] = {}


def register_backend(name: str):
    """Decorator: register a backend factory under ``name`` (DESIGN.md §4)."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available_backends():
    """Sorted names of every registered backend (DESIGN.md §4)."""
    return sorted(_REGISTRY)


def get_backend(name: str, **kwargs):
    """Instantiate a registered backend by name (DESIGN.md §4)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown decode backend {name!r}; "
                         f"available: {available_backends()}")
    return _REGISTRY[name](**kwargs)


def default_backend_name(device) -> str:
    """``"cuda"`` on a CUDA device, ``"reference"`` elsewhere (DESIGN.md §4)."""
    return "cuda" if torch.device(device).type == "cuda" else "reference"


def resolve_backend(backend: Union[None, str, object], device="cuda"):
    """Name | instance | None (the device's default) -> a backend."""
    if backend is None:
        return get_backend(default_backend_name(device))
    if isinstance(backend, str):
        return get_backend(backend)
    return backend


@register_backend("reference")
@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """Pure-torch dequantize -> attend (the oracle path; DESIGN.md §4)."""

    name: str = "reference"

    def attend(self, q, cache, cfg: ArchConfig, policy: QuantPolicy, *,
               window=None, dtype=torch.bfloat16):
        """One query token against the SKVQ cache (DESIGN.md §4)."""
        from .attention import decode_attention_skvq
        return decode_attention_skvq(q, cache, cfg, as_layer_policy(policy),
                                     window=window, dtype=dtype)

    def quant_fn(self, policy: QuantPolicy) -> Optional[Callable]:
        """None: kv_cache falls back to ``quantize_groups`` (DESIGN.md §2)."""
        as_layer_policy(policy)
        return None

    def info(self) -> dict:
        """Resolved runtime facts (DESIGN.md §4)."""
        return {"name": self.name, "kernels": False}


@register_backend("cuda")
@dataclasses.dataclass(frozen=True)
class CudaBackend:
    """The hand-written Hopper kernels: fused dequant + flash decode and
    fused quantize + pack (DESIGN.md §4)."""

    name: str = "cuda"

    def attend(self, q, cache, cfg: ArchConfig, policy: QuantPolicy, *,
               window=None, dtype=torch.bfloat16):
        """One query token via ``kernels.ops.cuda_decode_attention``, with
        ``BLOCK_S``-token tiles and dead-tile pruning (DESIGN.md §4)."""
        from ..kernels.ops import cuda_decode_attention
        from .attention import _scale
        return cuda_decode_attention(
            q, cache, as_layer_policy(policy), scale=_scale(cfg),
            softcap=cfg.attn_softcap, window=window, dtype=dtype)

    def quant_fn(self, policy: QuantPolicy) -> Optional[Callable]:
        """The ``kv_quant`` kernel, always (DESIGN.md §3 plane layout)."""
        as_layer_policy(policy)
        from ..kernels.ops import make_kernel_quant_fn
        return make_kernel_quant_fn()

    def info(self) -> dict:
        """Resolved runtime facts (DESIGN.md §4)."""
        return {"name": self.name, "kernels": True}
