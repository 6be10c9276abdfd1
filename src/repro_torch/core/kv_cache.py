"""SKVQ cache container, striped layout (port of ``repro.core.kv_cache``;
paper Sec. 3.2 + Alg. 1; DESIGN.md §1).

Token layout (absolute positions):

    [0, n_sink)                       fp sink buffer (kept forever)
    [n_sink, length - W)              packed quantized region
    [max(n_sink, length - W), length) fp sliding-window ring (last W tokens)

A cache is a plain dict of tensors with the reference's key names
(``length``, ``sink_k``, ``win_k``, ``qk_codes_hi``, ...), laid out
``(B, S, H_kv, ...)``; ``length`` is per-slot ``(B,)`` int32.

Unlike the reference, :func:`decode_append`, :func:`reset_slot` and
:func:`insert_slot` update the tensors **in place** (and return the same
dict), so a layer's cache may be a view into a layer-stacked buffer.
:func:`prefill` allocates a fresh cache.  The paged block pool (§9) is not
ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from .policy import QuantPolicy, as_layer_policy
from .quant import quantize_groups, plane_layout

Cache = Dict[str, torch.Tensor]
QuantFn = Callable[..., Dict[str, torch.Tensor]]


def _qtensor_shapes(batch: int, slots: int, n_kv: int, head_dim: int,
                    bits: float, group_size: int, meta_bits: int):
    """Shapes of the packed planes for one of K/V (DESIGN.md §3)."""
    shapes = {}
    meta_dt = torch.uint8 if meta_bits == 8 else torch.float16
    for name, (_, width, b, gs) in zip(("hi", "lo"),
                                       plane_layout(head_dim, bits, group_size)):
        shapes[f"codes_{name}"] = ((batch, slots, n_kv, width * b // 8),
                                   torch.uint8)
        shapes[f"scale_{name}"] = ((batch, slots, n_kv, width // gs), meta_dt)
        shapes[f"zero_{name}"] = ((batch, slots, n_kv, width // gs), meta_dt)
    return shapes


def cache_shapes(batch: int, max_len: int, n_kv: int, head_dim: int,
                 policy: QuantPolicy, dtype=torch.bfloat16):
    """Dict of name -> (shape, dtype) for one layer (DESIGN.md §1)."""
    policy = as_layer_policy(policy)
    if policy.is_fp16:
        return {"length": ((batch,), torch.int32),
                "k": ((batch, max_len, n_kv, head_dim), dtype),
                "v": ((batch, max_len, n_kv, head_dim), dtype)}
    w, ns = policy.window, policy.n_sink
    sq = max(0, max_len - ns - w)
    out = {"length": ((batch,), torch.int32)}
    if ns > 0:
        out["sink_k"] = ((batch, ns, n_kv, head_dim), dtype)
        out["sink_v"] = ((batch, ns, n_kv, head_dim), dtype)
    if w > 0:
        out["win_k"] = ((batch, w, n_kv, head_dim), dtype)
        out["win_v"] = ((batch, w, n_kv, head_dim), dtype)
    gsz = min(policy.group_size, head_dim)
    for pref, bits in (("qk", policy.bits_k), ("qv", policy.bits_v)):
        for k, v in _qtensor_shapes(batch, sq, n_kv, head_dim, bits, gsz,
                                    policy.meta_dtype_bits).items():
            out[f"{pref}_{k}"] = v
    return out


def init_cache(batch, max_len, n_kv, head_dim, policy, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Zero-filled cache dict for one layer (layout per DESIGN.md §1), on
    ``device`` (default CUDA; raises without a card unless ``"cpu"``)."""
    device = resolve_device(device)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in cache_shapes(batch, max_len, n_kv, head_dim,
                                          policy, dtype).items()}


def slot_lengths(cache: Cache, batch: Optional[int] = None) -> torch.Tensor:
    """Per-slot lengths (B,) (DESIGN.md §6).  A scalar length broadcasts."""
    t = cache["length"]
    if t.ndim == 0:
        if batch is None:
            batch = next(v.shape[0] for k, v in cache.items() if k != "length")
        t = t.expand(batch)
    return t


# ------------------------------------------------ per-slot token gather/put

def _rows(buf: torch.Tensor) -> torch.Tensor:
    return torch.arange(buf.shape[0], device=buf.device)


def _gat_tok(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf (B, S, H, W), idx (B,) -> the per-row token (B, 1, H, W)."""
    return buf[_rows(buf), idx.long()][:, None]


def _put_tok_where(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                   cond: torch.Tensor) -> None:
    """In place: write val (B, 1, H, W) at per-row index idx (B,) where
    cond (B,) holds; other rows keep their old token."""
    rows, idx = _rows(buf), idx.long()
    old = buf[rows, idx]
    buf[rows, idx] = torch.where(cond[:, None, None], val[:, 0], old)


# ------------------------------------------------------ slot lifecycle ops

def reset_slot(caches, i: int, batch_axis: int = 0):
    """In place: zero batch slot ``i`` of every leaf (DESIGN.md §6
    retirement).  Works on one cache dict or nested groups of
    layer-stacked caches (``batch_axis=1``)."""
    if isinstance(caches, dict):
        for v in caches.values():
            reset_slot(v, i, batch_axis)
        return caches
    caches.select(batch_axis, i).zero_()
    return caches


def insert_slot(dst, i: int, src, src_slot: int = 0, batch_axis: int = 0):
    """In place: copy batch row ``src_slot`` of ``src`` into slot ``i`` of
    ``dst`` (DESIGN.md §6 admission).  Non-batch dims must match."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            insert_slot(v, i, src[k], src_slot, batch_axis)
        return dst
    dst.select(batch_axis, i).copy_(src.select(batch_axis, src_slot))
    return dst


# ------------------------------------------------------------------ prefill

def prefill(k: torch.Tensor, v: torch.Tensor, max_len: int,
            policy: QuantPolicy, alpha_k: Optional[torch.Tensor] = None,
            alpha_v: Optional[torch.Tensor] = None,
            quant_fn: Optional[QuantFn] = None) -> Cache:
    """Build a new cache from prefill K/V (B, S, H_kv, D), S <= max_len
    (paper Sec. 3.2; DESIGN.md §1): all three segments written at once.

    K/V are already channel-reordered.  alpha_*: (H_kv, G_total) clip
    factors.  ``quant_fn(x, bits, group_size, alpha, fp8_meta)`` overrides
    the quantizer (the ``"cuda"`` backend passes the kv_quant kernel)."""
    policy = as_layer_policy(policy)
    qf = quant_fn or quantize_groups
    b, s, h, d = k.shape
    w, ns = policy.window, policy.n_sink
    cache = init_cache(b, max_len, h, d, policy, k.dtype, k.device)
    cache["length"].fill_(s)
    if policy.is_fp16:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        return cache
    if ns > 0:
        take = min(ns, s)
        cache["sink_k"][:, :take] = k[:, :take]
        cache["sink_v"][:, :take] = v[:, :take]
    if w > 0 and max(ns, s - w) < s:
        lo = max(ns, s - w)          # ring holds [lo, s) at (t - ns) % w
        slots = (torch.arange(lo, s, device=k.device) - ns) % w
        cache["win_k"][:, slots] = k[:, lo:s]
        cache["win_v"][:, slots] = v[:, lo:s]
    qc = max(0, s - ns - w)
    if qc > 0:
        gsz = min(policy.group_size, d)
        for name, x, bits, alpha in (("qk", k, policy.bits_k, alpha_k),
                                     ("qv", v, policy.bits_v, alpha_v)):
            qt = qf(x[:, ns:ns + qc], bits, gsz, alpha, policy.fp8_meta)
            for kk, vv in qt.items():
                cache[f"{name}_{kk}"][:, :qc] = vv
    return cache


# ------------------------------------------------------------------- decode

def decode_append(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                  policy: QuantPolicy,
                  alpha_k: Optional[torch.Tensor] = None,
                  alpha_v: Optional[torch.Tensor] = None,
                  quant_fn: Optional[QuantFn] = None,
                  valid: Optional[torch.Tensor] = None) -> Cache:
    """In place: append one token (k/v_new: (B, 1, H_kv, D)) per slot and
    quantize the token it evicts from the window (DESIGN.md §1).

    Every row advances at its own ``length``.  Rows with ``valid`` False
    (optional (B,) bool) are no-ops and do not advance.  Returns ``cache``."""
    policy = as_layer_policy(policy)
    qf = quant_fn or quantize_groups
    b, _, h, d = k_new.shape
    w, ns = policy.window, policy.n_sink
    t = slot_lengths(cache, b).clone()
    ok = (torch.ones(b, dtype=torch.bool, device=k_new.device) if valid is None
          else torch.as_tensor(valid, device=k_new.device).expand(b))

    def put_all(qk, qv, idx, cond):
        for name, qt in (("qk", qk), ("qv", qv)):
            for kk, vv in qt.items():
                full = cache[f"{name}_{kk}"]
                _put_tok_where(full, idx, vv.to(full.dtype), cond)

    if policy.is_fp16:
        idx = t.clamp(0, cache["k"].shape[1] - 1)
        for buf, x in (("k", k_new), ("v", v_new)):
            _put_tok_where(cache[buf], idx, x.to(cache[buf].dtype), ok)
        cache["length"].copy_(t + ok.to(t.dtype))
        return cache
    gsz = min(policy.group_size, d)
    is_sink = t < ns
    if w > 0:
        slot = (t - ns).clamp_min(0) % w
        u_e = t - ns - w          # packed-region index of the evicted token
        if "qk_codes_hi" in cache and cache["qk_codes_hi"].shape[1] > 0:
            idx = u_e.clamp(0, cache["qk_codes_hi"].shape[1] - 1)
            # gather the evicted tokens before the ring slot is overwritten
            ek = _gat_tok(cache["win_k"], slot)
            ev = _gat_tok(cache["win_v"], slot)
            put_all(qf(ek, policy.bits_k, gsz, alpha_k, policy.fp8_meta),
                    qf(ev, policy.bits_v, gsz, alpha_v, policy.fp8_meta),
                    idx, (u_e >= 0) & ok)
        for buf, x in (("win_k", k_new), ("win_v", v_new)):
            _put_tok_where(cache[buf], slot, x.to(cache[buf].dtype),
                           ~is_sink & ok)
    else:
        # no window: quantize immediately (the paper's no-window ablation)
        idx = (t - ns).clamp_min(0).clamp_max(cache["qk_codes_hi"].shape[1] - 1)
        put_all(qf(k_new, policy.bits_k, gsz, alpha_k, policy.fp8_meta),
                qf(v_new, policy.bits_v, gsz, alpha_v, policy.fp8_meta),
                idx, ok)
    if ns > 0:
        sidx = t.clamp(0, ns - 1)
        for buf, x in (("sink_k", k_new), ("sink_v", v_new)):
            _put_tok_where(cache[buf], sidx, x.to(cache[buf].dtype),
                           is_sink & ok)
    cache["length"].copy_(t + ok.to(t.dtype))
    return cache


# --------------------------------------------------------- byte accounting

def policy_cache_nbytes(max_len: int, n_kv: int, head_dim: int,
                        policy: QuantPolicy, dtype=torch.bfloat16) -> int:
    """Exact bytes of one layer's cache at capacity ``max_len`` (batch 1),
    straight from :func:`cache_shapes` (DESIGN.md §8)."""
    shapes = cache_shapes(1, max_len, n_kv, head_dim, policy, dtype)
    return sum(math.prod(s) * torch.empty((), dtype=d).element_size()
               for name, (s, d) in shapes.items() if name != "length")
