"""Pluggable decode-attention backends (port of ``repro.models.backends``;
DESIGN.md §4).

A backend answers "given a query token and the SKVQ cache, what is the
attention output?" and supplies the quantizer for tokens sliding out of the
fp window, so attention and quantization agree on the packed layout.

* ``"reference"`` — dequantize in the compute dtype, attend with the shared
  flash partials (``attention.decode_attention_skvq``); quantizes with
  ``core.quant.quantize_groups`` and appends with
  ``kv_cache.decode_append``.  The default off the card.
* ``"cuda"`` — the ``decode_attn`` kernel over the packed planes
  (``kernels.ops.cuda_decode_attention``), ALWAYS the bulk ``kv_quant``
  kernel as its prefill quantizer, and the fused ``kv_append`` kernel
  (one launch per layer) as its decode append, so every kernel is on the
  main path; chunked prefill appends through ``kv_append_chunk`` (one
  bulk ``kv_quant`` launch per plane per layer per chunk).  The
  counterpart of the reference's ``PallasBackend``; the default on a CUDA
  device.  On CPU tensors the kernels run their plain versions.  A layer
  whose policy is fp16 (a schedule's guard layer, DESIGN.md §8) has no
  packed planes: its route is chosen by the policy, statically, and runs
  torch ops (``kernels.ops``' fp16 route), as the JAX package computes
  fp16 layers outside any Pallas kernel.
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
               window=None, dtype=torch.bfloat16, chunk: int = 0,
               local_slice: int = 0, packed_override=None, extra_kv=None,
               q_pos=None, prune_blocks: bool = True):
        """One query token against the SKVQ cache (DESIGN.md §4), with the
        reference's levers (``attention.decode_attention_skvq``)."""
        from .attention import decode_attention_skvq
        return decode_attention_skvq(
            q, cache, cfg, as_layer_policy(policy), window=window,
            dtype=dtype, chunk=chunk, local_slice=local_slice,
            packed_override=packed_override, extra_kv=extra_kv, q_pos=q_pos,
            prune_blocks=prune_blocks)

    def quant_fn(self, policy: QuantPolicy) -> Optional[Callable]:
        """None: kv_cache falls back to ``quantize_groups`` (DESIGN.md §2)."""
        as_layer_policy(policy)
        return None

    def append_fn(self, policy: QuantPolicy) -> Callable:
        """``kv_cache.decode_append`` with the plain quantizer (DESIGN.md
        §1)."""
        as_layer_policy(policy)
        from ..core.kv_cache import decode_append
        return decode_append

    def chunk_append_fn(self, policy: QuantPolicy) -> Callable:
        """The chunked-prefill append, called ``fn(cache, k, v, policy, t0,
        n_valid, alpha_k, alpha_v)``: ``kv_cache.prefill_chunk_append``,
        the token loop with the plain quantizer (DESIGN.md §7)."""
        as_layer_policy(policy)
        from ..core.kv_cache import prefill_chunk_append

        def chunk_append(cache, k, v, policy, t0, n_valid, alpha_k=None,
                         alpha_v=None):
            return prefill_chunk_append(cache, k, v, policy, n_valid,
                                        alpha_k, alpha_v)
        return chunk_append

    def info(self) -> dict:
        """Resolved runtime facts (DESIGN.md §4)."""
        return {"name": self.name, "kernels": False}


@register_backend("cuda")
@dataclasses.dataclass(frozen=True)
class CudaBackend:
    """The hand-written Hopper kernels: fused dequant + flash decode, fused
    quantize + pack, and the fused decode append (DESIGN.md §4)."""

    name: str = "cuda"

    def attend(self, q, cache, cfg: ArchConfig, policy: QuantPolicy, *,
               window=None, dtype=torch.bfloat16, chunk: int = 0,
               local_slice: int = 0, packed_override=None, extra_kv=None,
               q_pos=None, prune_blocks: bool = True):
        """One query token via ``kernels.ops.cuda_decode_attention``, with
        ``BLOCK_S``-token tiles and dead-tile pruning (DESIGN.md §4), and
        the reference's levers."""
        from ..kernels.ops import cuda_decode_attention
        from .attention import _scale
        return cuda_decode_attention(
            q, cache, as_layer_policy(policy), scale=_scale(cfg),
            softcap=cfg.attn_softcap, window=window, dtype=dtype,
            chunk=chunk, local_slice=local_slice,
            packed_override=packed_override, extra_kv=extra_kv, q_pos=q_pos,
            prune_blocks=prune_blocks)

    def quant_fn(self, policy: QuantPolicy) -> Optional[Callable]:
        """The bulk ``kv_quant`` kernel for every quantized policy
        (DESIGN.md §3 plane layout); None for an fp16 one, whose prefill
        quantizes nothing."""
        if as_layer_policy(policy).is_fp16:
            return None
        from ..kernels.ops import make_kernel_quant_fn
        return make_kernel_quant_fn()

    def append_fn(self, policy: QuantPolicy) -> Callable:
        """The fused ``kv_append`` kernel: the whole decode append of a
        layer in one launch (DESIGN.md §1); an fp16 policy's row write
        (``kernels.ops.fp16_append``)."""
        if as_layer_policy(policy).is_fp16:
            from ..kernels.ops import fp16_append
            return fp16_append
        from ..kernels.kv_quant import kv_append
        return kv_append

    def chunk_append_fn(self, policy: QuantPolicy) -> Callable:
        """``kernels.kv_quant.kv_append_chunk``: a chunk's evicted rows
        quantized by one bulk ``kv_quant`` launch per plane (DESIGN.md
        §7); an fp16 policy's bulk row write
        (``kernels.ops.fp16_chunk_append``)."""
        if as_layer_policy(policy).is_fp16:
            from ..kernels.ops import fp16_chunk_append
            return fp16_chunk_append
        from ..kernels.kv_quant import kv_append_chunk
        return kv_append_chunk

    def info(self) -> dict:
        """Resolved runtime facts (DESIGN.md §4)."""
        return {"name": self.name, "kernels": True}
