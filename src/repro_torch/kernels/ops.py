"""Host side of the two kernels (port of ``repro.kernels.ops``; DESIGN.md
§4).

:func:`cuda_decode_attention` is the ``"cuda"`` decode backend: the packed
segment goes through the ``decode_attn`` kernel with per-slot block bounds
computed on the device, the small fp sink/window segment runs as torch
ops, and the partials merge by logsumexp.  :func:`make_kernel_quant_fn`
routes prefill-side quantization through the bulk ``kv_quant`` kernel
(the decode append has its own kernel, ``kv_quant.kv_append``).

A pooled cache (DESIGN.md §9) keeps its planes pool-major and hands the
kernel its ``block_tbl``: the mask and bounds are computed in logical
coordinates at the striped tile, and nothing is gathered on the host side.

A layer whose policy is fp16 (a guard layer of a schedule, DESIGN.md §8)
has nothing packed, so no kernel runs for it, as in the JAX package: the
route is chosen by the policy, never by a failed launch.
:func:`cuda_decode_attention` attends over its dense cache with the shared
``segments.partial_attend``/``finalize``, and :func:`fp16_append` /
:func:`fp16_chunk_append` write its rows with ``kv_cache``'s fp16
branches; ``FP16_CALLS`` counts the three (``launch_counts()["fp16"]``).

The local-window levers of the unrolled decode (``local_slice``,
``packed_override``) hand the kernel a per-slot sliced view of the packed
planes, walked in striped mode; a pooled cache is gathered into its
striped view first for them, as in the JAX package.  The pre-append
protocol's current token (``extra_kv``, ``q_pos``) joins the fp partial
in torch.
"""
from __future__ import annotations

import torch

from .. import spans
from ..core.policy import QuantPolicy
from ..core.quant import n_meta_groups, packed_nbytes, plane_layout
from ..core import segments as seg
from ..core import kv_cache as kvc
from ..core.kv_cache import is_pooled, slot_lengths
from .decode_attn import BLOCK_S, decode_attn
from .kv_quant import ROW_MAX, kernel_layout, kv_quant

_FAR = 2 ** 30  # position of padded packed slots (always masked out)
FP16_CALLS = {"attend": 0, "append": 0, "chunk_append": 0}


def _need_fp16(policy: QuantPolicy, what: str):
    if not policy.is_fp16:
        raise ValueError(f"{what} is the fp16 route; a quantized policy "
                         f"takes the kernels")


def fp16_append(cache, k_new, v_new, policy: QuantPolicy, alpha_k=None,
                alpha_v=None, valid=None):
    """The decode append of an fp16 layer (DESIGN.md §8): row ``length`` of
    ``k``/``v`` by a device-side index, no host read, so it is captured in
    the step's graph (``kv_cache.decode_append``'s fp16 branch)."""
    _need_fp16(policy, "fp16_append")
    FP16_CALLS["append"] += 1
    return kvc.decode_append(cache, k_new, v_new, policy, valid=valid)


def fp16_chunk_append(cache, k, v, policy: QuantPolicy, t0, n_valid,
                      alpha_k=None, alpha_v=None):
    """The chunked-prefill append of an fp16 layer: the chunk's rows
    written in bulk (``kv_cache.prefill_chunk_append``'s fp16 branch)."""
    _need_fp16(policy, "fp16_chunk_append")
    FP16_CALLS["chunk_append"] += 1
    return kvc.prefill_chunk_append(cache, k, v, policy, n_valid)


def _block_pad(s_eff: int, block_s: int):
    """Kernel tile width + padded token count for an ``s_eff``-token packed
    view (shared with :func:`decode_block_report`)."""
    bs = min(block_s, max(s_eff, 8))
    return bs, -(-s_eff // bs) * bs


def _packed_ok(j, lens, t_now, weff, policy: QuantPolicy, b: int):
    """Per-slot attendability over (padded) packed slots ``j`` — the mask
    the kernel applies and the one the ``[lo, hi)`` bounds come from."""
    pos_q, stored_q = seg.packed_segment(j, lens, policy.n_sink,
                                         policy.window)
    return seg.bcast_rows(seg.attend_ok(pos_q, stored_q, t_now, weff), b)


def _packed_capacity(cache) -> int:
    """Logical packed tokens per slot: the plane length, or NB * BT for a
    pooled cache."""
    if "qk_codes_hi" not in cache:
        return 0
    s = cache["qk_codes_hi"].shape[1]
    return cache["block_tbl"].shape[-1] * s if is_pooled(cache) else s


def _pad_j(j: torch.Tensor, s_pad: int) -> torch.Tensor:
    """Packed indices ``j`` ((S,) or per-slot (B, S)) padded along the last
    axis to ``s_pad`` with the always-masked position."""
    j = j.to(torch.int32)
    tail = torch.full((*j.shape[:-1], s_pad - j.shape[-1]), _FAR,
                      dtype=torch.int32, device=j.device)
    return torch.cat([j, tail], dim=-1)


def _padded_j(s_q: int, s_pad: int, device) -> torch.Tensor:
    """``arange(s_q)`` padded to ``s_pad`` (:func:`_pad_j`)."""
    return _pad_j(torch.arange(s_q, dtype=torch.int32, device=device), s_pad)


def split_width(d: int, bits: float, group_size: int) -> int:
    """Width of the rows a ``d``-channel row wider than the kernel takes
    (``ROW_MAX``) is cut into, exactly: the widest ``w`` up to the
    limit that divides ``d`` into whole groups of one plane the kernel
    lays out (``kv_quant.kernel_layout``).  The codes, scale and zero of
    the ``d // w`` rows, side by side, are then the row's own bytes.  A
    row of two planes (a fractional width) or of groups wider than the
    limit has no such cut: ValueError (KIVI's per-channel keys at a long
    context are the rows this serves)."""
    gs = min(group_size, d)
    if len(plane_layout(d, bits, gs)) == 1:
        for w in range(ROW_MAX - ROW_MAX % gs, 0, -gs):
            if d % w == 0:
                try:
                    kernel_layout(w, bits, gs)
                except ValueError:
                    continue
                return w
    raise ValueError(
        f"kv_quant kernel: a {d}-channel row at {bits} bits, group {gs}, has "
        f"no exact split into rows of at most {ROW_MAX} channels "
        f"(one plane, whole groups, a width the kernel lays out)")


def make_kernel_quant_fn():
    """A ``quant_fn`` for ``kv_cache.prefill``/``decode_append``: flattens
    the leading axes to kernel rows and calls the ``kv_quant`` kernel
    (plain version on CPU).  Per-head clip factors (H, G) pass through
    as they are — rows flattened from (..., H, D) read them by row % H —
    and only other shapes are tiled onto the rows.  A row wider than
    ``ROW_MAX`` is cut into rows of :func:`split_width` channels
    (its clip factors with it) on either device, or refused."""
    def quant_fn(x, bits, group_size, alpha, fp8_meta):
        *lead, d = x.shape
        n = 1
        for s in lead:
            n *= s
        gs = min(group_size, d)
        if alpha is not None:
            alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                    device=x.device)
            per_head = alpha.ndim == 2 and lead and alpha.shape[0] == lead[-1]
            if alpha.ndim > 1 and not per_head:
                g_total = n_meta_groups(d, bits, gs)
                alpha = alpha.expand(*lead, g_total).reshape(n, g_total)
        rows, c = x.reshape(n, d), 1
        if d > ROW_MAX:
            w = split_width(d, bits, gs)
            c = d // w
            rows = rows.reshape(n * c, w)
            if alpha is not None and alpha.numel() > 1:
                # row r's groups j*w/gs.. go with its piece j: (P, G) ->
                # (P * c, w / gs), read by piece index % (P * c)
                alpha = alpha.reshape(-1, w // gs)
        qt = kv_quant(rows, bits, gs, alpha=alpha, fp8_meta=fp8_meta)
        return {k: v.reshape(*lead, c * v.shape[-1]) for k, v in qt.items()}
    return quant_fn


def cuda_decode_attention(q, cache, policy: QuantPolicy, *, scale: float,
                          softcap: float = 0.0, window=None,
                          dtype=torch.bfloat16, chunk: int = 0,
                          local_slice: int = 0, packed_override=None,
                          extra_kv=None, q_pos=None,
                          block_s: int = BLOCK_S, prune_blocks: bool = True):
    """Fused-kernel decode over the SKVQ cache (DESIGN.md §4).

    q (B, 1, Hq, D) -> (B, 1, Hq, D); the query token is already appended,
    or, in the pre-append protocol, rides as ``extra_kv = (k, v, pos)``
    with ``q_pos`` its position.  ``cache["length"]`` is per-slot, so the
    kernel takes a per-(slot, token) mask.  With ``prune_blocks`` the mask
    reduces on the device to per-slot block bounds ``[lo, hi)`` and the
    kernel skips dead tiles, bit-identically to the full walk.  A pooled
    cache takes the kernel's block-table mode at the same tile as a
    striped cache of the same capacity, so the two give bitwise equal
    results (DESIGN.md §9).

    ``local_slice``/``packed_override`` narrow the walk to a per-slot view
    (``attention.packed_view``) that the kernel walks in striped mode,
    padded to its tile; a pooled cache is unpooled first for them, as the
    reference's wrapper does (``repro/kernels/ops.py:167-170``).
    ``chunk`` is accepted and ignored, as there: the kernel streams
    ``block_s``-token tiles.

    An fp16 policy has nothing packed: it attends over the dense ``k``/
    ``v`` cache with the shared flash partial, no kernel (the JAX
    package's fallback, ``repro.kernels.ops``)."""
    from ..models.attention import fp_segment_partial, packed_view
    b, _, hq, d = q.shape
    with spans.region("attn.mask"):
        if is_pooled(cache) and (packed_override is not None or local_slice):
            cache = kvc.unpool_cache(cache)
        lens = slot_lengths(cache, b)
        t_now = lens - 1 if q_pos is None else torch.as_tensor(
            q_pos, device=lens.device).expand(b)
        weff = seg.effective_window(window)
    if policy.is_fp16:
        FP16_CALLS["attend"] += 1
        with spans.region("attn.segment"):
            hkv = cache["k"].shape[2]
            qg = q.reshape(b, hkv, hq // hkv, d)
            pos = torch.arange(cache["k"].shape[1], device=q.device)
            ok = seg.attend_ok(pos, pos[None, :] < lens[:, None], t_now,
                               weff)
            part = seg.partial_attend(qg, cache["k"].to(dtype),
                                      cache["v"].to(dtype), ok, scale,
                                      softcap)
            return seg.finalize([part]).reshape(b, 1, hq, d).to(q.dtype)
    hkv = (cache["win_k"] if "win_k" in cache else cache["qk_codes_hi"]
           ).shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    parts = []
    s_q = _packed_capacity(cache)
    if s_q > 0:
        with spans.region("attn.mask"):
            if packed_override is not None or (local_slice
                                               and s_q > local_slice):
                k_qt, v_qt, j = packed_view(cache, policy, lens, local_slice,
                                            packed_override)
            else:       # the whole region; a pooled cache keeps its table
                k_qt = {kk[3:]: vv for kk, vv in cache.items()
                        if kk.startswith("qk_")}
                v_qt = {kk[3:]: vv for kk, vv in cache.items()
                        if kk.startswith("qv_")}
                j = torch.arange(s_q, dtype=torch.int32, device=q.device)
            bs, s_pad = _block_pad(j.shape[-1], block_s)
            ok = _packed_ok(_pad_j(j, s_pad), lens, t_now, weff, policy, b)
            bounds = seg.packed_block_bounds(ok, bs) if prune_blocks \
                else None
            mask = ok.to(torch.float32)
        with spans.region("attn.kernel"):
            num, m, l = decode_attn(qg, k_qt, v_qt, mask, policy, d, scale,
                                    block_s=bs, softcap=softcap,
                                    block_bounds=bounds,
                                    block_table=cache.get("block_tbl"))
        parts.append((num, m[..., 0], l[..., 0]))
    with spans.region("attn.segment"):
        parts.extend(fp_segment_partial(qg, cache, policy, lens, t_now, weff,
                                        scale, softcap, dtype, extra_kv))
        return seg.finalize(parts).reshape(b, 1, hq, d).to(q.dtype)


def decode_block_report(cache, policy: QuantPolicy, head_dim: int, *,
                        window=None, block_s: int = BLOCK_S):
    """Pruning accounting for the packed walk (DESIGN.md §4): ``bounds``
    (B, 2), ``visited`` (B,) blocks, ``total`` capacity blocks and
    ``bytes_per_block`` packed-plane bytes one block moves (all kv heads).
    A pooled cache (§9) counts its logical capacity NB * BT at the same
    tile as the kernel walks it."""
    s_q = _packed_capacity(cache)
    lens = slot_lengths(cache)
    b = lens.shape[0]
    if s_q == 0 or policy.is_fp16:
        zeros = torch.zeros((b,), dtype=torch.int32, device=lens.device)
        return {"bounds": torch.zeros((b, 2), dtype=torch.int32,
                                      device=lens.device),
                "visited": zeros, "total": 0, "bytes_per_block": 0}
    bs, s_pad = _block_pad(s_q, block_s)
    ok = _packed_ok(_padded_j(s_q, s_pad, lens.device), lens, lens - 1,
                    seg.effective_window(window), policy, b)
    bounds = seg.packed_block_bounds(ok, bs)
    hkv = cache["qk_codes_hi"].shape[2]
    gsz = min(policy.group_size, head_dim)
    per_tok = (packed_nbytes(head_dim, policy.bits_k, gsz,
                             policy.meta_dtype_bits)
               + packed_nbytes(head_dim, policy.bits_v, gsz,
                               policy.meta_dtype_bits))
    return {"bounds": bounds, "visited": seg.blocks_visited(bounds),
            "total": s_pad // bs, "bytes_per_block": bs * hkv * per_tok}
