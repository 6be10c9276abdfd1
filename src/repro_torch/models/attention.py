"""Attention for the port's models (port of the full-sequence, prefill and
reference-decode paths of ``repro.models.attention``).

* :func:`full_attention` — plain f32 softmax attention over a whole
  sequence, causal, local-band or bidirectional, query-chunked above
  ``Q_CHUNK``: the encoder and the cross-attention of the enc-dec family.
* :func:`prefill_block_attention` — full-precision causal prefill with the
  reference's FIXED 128-wide key-block online-softmax loop (DESIGN.md §7:
  chunked prefill depends on this reduction structure), and
  :func:`prefill_chunk_attention`, the same loop for a chunk of queries
  over the chunked-prefill workspace.
* :func:`decode_attention_skvq` — the ``"reference"`` backend: dequantize
  the packed region in the compute dtype and attend with the shared flash
  partials (DESIGN.md §4); a pooled cache is unpooled first (§9).  With
  the reference's levers: ``chunk`` tiles (dead ones skipped),
  ``local_slice`` / ``packed_override`` views of a local layer's window,
  and the pre-append ``extra_kv`` / ``q_pos`` protocol.
* :func:`decode_attention` and :func:`decode_attention_fp` — one token
  over gathered full-precision K/V (the plain-cache baseline).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import softcap
from ..core.policy import QuantPolicy
from ..core import kv_cache as kvc
from ..core import segments as seg
from ..core.quant import dequantize_groups
from ..distributed.sharding import (P, axis_size, current_mesh, is_sharded,
                                    logical, run_local, spec_for)

_NEG = -1e30
PREFILL_BLOCK = 128  # key-block width of the prefill reduction


def _scale(cfg: ArchConfig) -> float:
    return cfg.query_scale if cfg.query_scale > 0 else cfg.head_dim ** -0.5


def _band_mask(pos_q, pos_k, window_eff: int):
    """(Sq, Sk) causal ∧ local-band mask; window 0 = full."""
    d = pos_q[:, None] - pos_k[None, :]
    w = window_eff if window_eff > 0 else 2 ** 30
    return (d >= 0) & (d < w)


Q_CHUNK = 1024  # query-chunked attention above this sequence length


def _attn_block(qg, k, v, pos_q, pos_k, window: int, cfg: ArchConfig,
                bidirectional: bool):
    """qg (B, Sq, Hkv, G, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hkv, G, D)
    f32: f32 scores, softcap, mask, softmax, f32 values."""
    s = torch.einsum("bskgd,btkd->bkgst",
                     qg.to(torch.float32) * _scale(cfg), k.to(torch.float32))
    s = softcap(s, cfg.attn_softcap)
    if not bidirectional:
        s = s.masked_fill(~_band_mask(pos_q, pos_k, window), _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))


def full_attention(q, k, v, cfg: ArchConfig, *,
                   window: Optional[int] = None, bidirectional: bool = False,
                   q_chunk: int = Q_CHUNK):
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) at positions ``arange`` ->
    (B, Sq, Hq, D) in q's dtype (reference ``attention.full_attention``).
    ``window`` 0 or None is full attention, > 0 a causal local band;
    ``bidirectional`` masks nothing.  Above ``q_chunk`` queries, the
    queries run in chunks of ``q_chunk`` (the last may be shorter), so the
    (Sq, Sk) score tensor is never whole; each query row's softmax is its
    own, so chunking changes no row's math.

    On DTensors (a sharding context) each rank attends over its own
    batch rows and heads, whole sequences: q/k/v laid out by
    :func:`_head_spec`, the plain math on the local shards."""
    if is_sharded(q):
        spec = _head_spec(q, k)
        return run_local(lambda *t: full_attention(
            *t, cfg, window=window, bidirectional=bidirectional,
            q_chunk=q_chunk), (q, k, v), (spec, spec, spec), spec)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pos_q = torch.arange(sq, dtype=torch.int32, device=q.device)
    pos_k = torch.arange(sk, dtype=torch.int32, device=q.device)
    w = 0 if window is None else int(window)
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    step = q_chunk if q_chunk and sq > q_chunk else sq
    o = torch.cat([_attn_block(qg[:, i:i + step], k, v, pos_q[i:i + step],
                               pos_k, w, cfg, bidirectional)
                   for i in range(0, sq, step)], dim=1)
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _head_spec(q, k) -> P:
    """The layout attention runs in on a mesh: batch rows by the rules'
    ``batch`` axes and heads by their ``heads`` axes, each where it
    divides (the heads only where both q's and k's counts divide, so a
    rank's query heads find their kv heads), whole sequences."""
    mesh = current_mesh()
    b_ax, _, h_ax, _ = spec_for("batch", None, "heads", None)
    if b_ax is not None and q.shape[0] % axis_size(mesh, b_ax):
        b_ax = None
    if h_ax is not None and (q.shape[2] % axis_size(mesh, h_ax)
                             or k.shape[2] % axis_size(mesh, h_ax)):
        h_ax = None
    return P(b_ax, None, h_ax, None)


def prefill_block_attention(q, k, v, cfg: ArchConfig, *, pos_q=None,
                            window: Optional[int] = None,
                            block: int = PREFILL_BLOCK):
    """Causal prefill attention over ``block``-wide key tiles with
    online-softmax merging (DESIGN.md §7).  q (B, Sq, Hq, D); k/v
    (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype.  On DTensors each
    rank runs the loop over its own batch rows and heads, as
    :func:`full_attention` does."""
    if is_sharded(q):
        spec = _head_spec(q, k)
        return run_local(lambda *t: prefill_block_attention(
            *t, cfg, pos_q=pos_q, window=window, block=block), (q, k, v),
            (spec, spec, spec), spec)
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    dev = q.device
    if pos_q is None:
        pos_q = torch.arange(sq, dtype=torch.int32, device=dev)
    w = 0 if window is None else int(window)
    s_pad = -(-k.shape[1] // block) * block
    pad = (0, 0, 0, 0, 0, s_pad - k.shape[1])
    kp = F.pad(k, pad).to(torch.float32)
    vp = F.pad(v, pad).to(torch.float32)
    # (B, Hkv, G, Sq, D), scaled once
    qg = (q.reshape(b, sq, hkv, g, d).to(torch.float32) * _scale(cfg)
          ).permute(0, 2, 3, 1, 4)
    num = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for i in range(s_pad // block):
        kb = kp[:, i * block:(i + 1) * block].permute(0, 2, 3, 1)  # B,K,D,T
        vb = vp[:, i * block:(i + 1) * block].permute(0, 2, 1, 3)  # B,K,T,D
        s = torch.matmul(qg, kb[:, :, None])                       # B,K,G,S,T
        s = softcap(s, cfg.attn_softcap)
        pb = torch.arange(i * block, (i + 1) * block, dtype=torch.int32,
                          device=dev)
        s = s.masked_fill(~_band_mask(pos_q, pb, w), _NEG)
        mb = s.amax(dim=-1)
        u = torch.exp(s - mb[..., None])
        nb_ = torch.matmul(u, vb[:, :, None])
        lb = u.sum(dim=-1)
        mn = torch.maximum(m, mb)
        wa = torch.exp(m - mn)
        wb = torch.exp(mb - mn)
        num = num * wa[..., None] + nb_ * wb[..., None]
        m, l = mn, l * wa + lb * wb
    o = num / l.clamp_min(1e-30)[..., None]                        # B,K,G,S,D
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def prefill_chunk_attention(q, ws_k, ws_v, pos_q, cfg: ArchConfig,
                            window: Optional[int] = None,
                            frontier: Optional[int] = None):
    """A chunk of prompt queries against the prefill workspace (DESIGN.md
    §7): :func:`prefill_block_attention` over ``ws_k``/``ws_v`` (B, cap,
    Hkv, D), token ``t`` at row ``t``, with the chunk's absolute positions
    ``pos_q`` (C,) from ``segments.chunk_segment``.

    Causality alone keeps every row at or past the written frontier (stale
    rows of a recycled workspace included) away from every valid query.
    ``frontier`` (host int ``t0 + n_valid``) cuts the key loop after the
    last block that holds a written row: every later block is fully
    masked for every valid query and would merge with weight
    ``exp(_NEG - m) == 0``, an exact no-op, so valid rows are bitwise the
    same as over the whole workspace.  Bucket-padding query rows differ;
    their outputs are discarded."""
    if frontier is not None:
        rows = -(-int(frontier) // PREFILL_BLOCK) * PREFILL_BLOCK
        ws_k, ws_v = ws_k[:, :rows], ws_v[:, :rows]
    return prefill_block_attention(q, ws_k, ws_v, cfg, pos_q=pos_q,
                                   window=window)


def decode_attention(q, keys, values, pos_k, valid, t_now, cfg: ArchConfig,
                     window: Optional[int] = None):
    """One-token attention over gathered full-precision segments.

    q (B, 1, Hq, D); keys/values (B, T, Hkv, D); ``pos_k``/``valid`` (T,)
    or per-slot (B, T); ``t_now`` the query's absolute position, a scalar
    or (B,).  A plain softmax in f32, as the reference's."""
    b, _, hq, d = q.shape
    hkv = keys.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).to(torch.float32) * _scale(cfg)
    s = torch.einsum("bkgd,btkd->bkgt", qg, keys.to(torch.float32))
    s = softcap(s, cfg.attn_softcap)
    ok = seg.attend_ok(pos_k, valid, t_now, seg.effective_window(window))
    okb = ok[None, None, None, :] if ok.ndim == 1 else ok[:, None, None, :]
    s = torch.where(okb, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, values.to(torch.float32))
    return o.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_fp(q, cache, cfg: ArchConfig,
                        window: Optional[int] = None):
    """Decode over a plain full-precision cache ``{k, v, length}`` (the
    baseline): the query token is already appended."""
    lens = kvc.slot_lengths(cache, q.shape[0])
    pos = torch.arange(cache["k"].shape[1], dtype=torch.int32,
                       device=q.device)
    k = logical(cache["k"], "batch", "kv_seq", "kv_heads", None)
    v = logical(cache["v"], "batch", "kv_seq", "kv_heads", None)
    return decode_attention(q, k, v, pos, pos[None, :] < lens[:, None],
                            lens - 1, cfg, window)


def take_tokens(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Per-slot gather along the token axis of packed planes: ``a``
    (..., B, S, H, W), ``j`` (B, n) token indices -> (..., B, n, H, W),
    a contiguous copy."""
    idx = j[:, :, None, None].expand(*a.shape[:-4], *j.shape, *a.shape[-2:])
    return torch.gather(a, a.ndim - 3, idx)


def slice_indices(lens, policy: QuantPolicy, lw: int, s_q: int
                  ) -> torch.Tensor:
    """(B, lw) packed indices of each slot's last ``lw`` packed tokens,
    for slots holding ``lens`` tokens once the step's token is appended:
    ``start = clip(qc - lw, 0, s_q - lw)``, ``qc`` the packed count
    (reference ``attention.py:306-326``, ``transformer.py:923-950``)."""
    qc = seg.quantized_count(lens, policy.n_sink, policy.window)
    return (qc - lw).clamp(0, s_q - lw)[:, None] + torch.arange(
        lw, device=qc.device)


def packed_planes(cache):
    """The packed K and V plane dicts of a (layer or band) cache, their
    ``qk_``/``qv_`` prefixes stripped."""
    return ({kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")},
            {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")})


def packed_view(cache, policy: QuantPolicy, lens, local_slice: int = 0,
                packed_override=None):
    """The packed planes a decode walks and their packed indices ``j``:
    ``packed_override`` ``(k_qt, v_qt, j)`` as given (the unrolled step's
    hoisted slice), else each slot's last ``local_slice`` packed tokens
    (:func:`slice_indices`, when the region is longer), else the whole
    region with ``j = arange(s_q)``.  Shared by both decode backends
    (reference ``attention.py:306-326``)."""
    if packed_override is not None:
        return packed_override
    k_qt, v_qt = packed_planes(cache)
    s_q = k_qt["codes_hi"].shape[1]
    if local_slice and s_q > local_slice:
        j = slice_indices(lens, policy, local_slice, s_q)
        return ({kk: take_tokens(vv, j) for kk, vv in k_qt.items()},
                {kk: take_tokens(vv, j) for kk, vv in v_qt.items()}, j)
    return k_qt, v_qt, torch.arange(s_q, device=k_qt["codes_hi"].device)


def decode_attention_skvq(q, cache, cfg: ArchConfig, policy: QuantPolicy,
                          window: Optional[int] = None,
                          dtype=torch.bfloat16, chunk: int = 0,
                          local_slice: int = 0, packed_override=None,
                          extra_kv=None, q_pos=None,
                          prune_blocks: bool = True):
    """Reference decode over the SKVQ cache: dequantize -> attend
    (DESIGN.md §4).  Per-slot aware: ``cache["length"]`` is (B,).  q
    (B, 1, Hq, D) -> (B, 1, Hq, D).  A pooled cache (§9) is gathered into
    its striped view first, so pooled decode equals striped decode on this
    backend by construction.

    By default the query token is already appended.  The pre-append
    protocol passes it as ``extra_kv = (k, v, pos)`` (one more fp segment)
    with ``q_pos`` its position.  ``local_slice``/``packed_override``
    narrow the packed walk (:func:`packed_view`).  ``chunk`` walks the
    packed view in ``chunk``-token tiles merged online (when it divides
    the view); with ``prune_blocks`` a tile no slot can attend
    (``segments.block_live``) is skipped, whose merge would be an exact
    no-op.  The skip reads the tiles' liveness on the host once a call:
    this is the oracle path, not the served one.  Where the liveness
    cannot be read on the host (a fake or meta tensor, a DTensor: a
    dry-run's trace), every tile is attended and a dead tile's merge is
    discarded by a select on the device, as the reference's ``lax.cond``
    discards it."""
    return skvq_parts(q, cache, cfg, policy, window=window, dtype=dtype,
                      chunk=chunk, local_slice=local_slice,
                      packed_override=packed_override, extra_kv=extra_kv,
                      q_pos=q_pos, prune_blocks=prune_blocks)[0]


def _host_readable(t: torch.Tensor) -> bool:
    """Whether ``t``'s values can be read on the host: not a meta or fake
    tensor (a dry-run's trace) and not a DTensor."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    return not (t.is_meta or is_fake(t) or isinstance(t, DTensor))


def skvq_parts(q, cache, cfg: ArchConfig, policy: QuantPolicy,
               window: Optional[int] = None, dtype=torch.bfloat16,
               chunk: int = 0, local_slice: int = 0, packed_override=None,
               extra_kv=None, q_pos=None, prune_blocks: bool = True,
               fp: bool = True, packed_keep=None):
    """:func:`decode_attention_skvq`'s work: (the normalized output
    (B, 1, Hq, D), the flash partials ``[(num, m, l), ...]`` it merged:
    the packed segment's first where there is one, then the fp
    segments').  ``fp`` False leaves the fp segments out (the output is
    then the packed segment's alone): a rank of a context-parallel cache
    merges its packed partial with the other ranks' before the fp one
    joins.  ``packed_keep`` (B, S_eff) bool narrows the packed walk to
    the tokens it marks (that rank's part of the unrolled step's local
    slice)."""
    if kvc.is_pooled(cache):
        cache = kvc.unpool_cache(cache)
    w, ns = policy.window, policy.n_sink
    b, _, hq, d = q.shape
    lens = kvc.slot_lengths(cache, b)
    t_now = lens - 1 if q_pos is None else torch.as_tensor(
        q_pos, device=lens.device).expand(b)
    scale = _scale(cfg)
    weff = seg.effective_window(window)

    if policy.is_fp16:  # uncompressed-cache baseline
        hkv = cache["k"].shape[2]
        qg = q.reshape(b, hkv, hq // hkv, d)
        pos = torch.arange(cache["k"].shape[1], device=q.device)
        ok = seg.attend_ok(pos, pos[None, :] < lens[:, None], t_now, weff)
        kf = logical(cache["k"], "batch", "kv_seq", "kv_heads", None)
        vf = logical(cache["v"], "batch", "kv_seq", "kv_heads", None)
        part = seg.partial_attend(qg, kf.to(dtype), vf.to(dtype), ok,
                                  scale, cfg.attn_softcap)
        out = part[0] / part[2].clamp_min(1e-30)[..., None]
        return out.reshape(b, 1, hq, d).to(q.dtype), [part]

    hkv = (cache["win_k"] if "win_k" in cache else cache["qk_codes_hi"]
           ).shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    parts = []
    s_q = cache["qk_codes_hi"].shape[1] if "qk_codes_hi" in cache else 0
    if s_q > 0:
        gsz = min(policy.group_size, d)
        k_qt, v_qt, j = packed_view(cache, policy, lens, local_slice,
                                    packed_override)
        pos_q, stored_q = seg.packed_segment(j, lens, ns, w)
        ok_q = seg.bcast_rows(seg.attend_ok(pos_q, stored_q, t_now, weff), b)
        if packed_keep is not None:
            ok_q = ok_q & packed_keep

        def dq(qt, bits):
            return dequantize_groups(qt, d, bits, gsz, policy.fp8_meta, dtype)

        sq_eff = k_qt["codes_hi"].shape[1]
        if chunk and sq_eff > chunk and sq_eff % chunk == 0:
            nc = sq_eff // chunk
            live = seg.block_live(ok_q, chunk).any(dim=0) if prune_blocks \
                else None
            on_host = live is not None and _host_readable(live)
            if on_host:
                live = live.tolist()
            part = (torch.zeros((b, hkv, hq // hkv, d), dtype=torch.float32,
                                device=q.device),
                    torch.full((b, hkv, hq // hkv), _NEG,
                               dtype=torch.float32, device=q.device),
                    torch.zeros((b, hkv, hq // hkv), dtype=torch.float32,
                                device=q.device))
            for c in range(nc):
                if on_host and not live[c]:
                    continue          # a dead tile: an exact no-op merge
                sl = slice(c * chunk, (c + 1) * chunk)
                tile = lambda qt: {kk: vv[:, sl] for kk, vv in qt.items()}
                new = seg.merge_partials(part, seg.partial_attend(
                    qg, dq(tile(k_qt), policy.bits_k),
                    dq(tile(v_qt), policy.bits_v), ok_q[:, sl], scale,
                    cfg.attn_softcap))
                if live is not None and not on_host:
                    # the reference's lax.cond, as a select on the device
                    new = tuple(torch.where(live[c], a, o)
                                for a, o in zip(new, part))
                part = new
            parts.append(part)
        else:
            keys = logical(dq(k_qt, policy.bits_k),
                           "batch", "kv_seq", "kv_heads", None)
            values = logical(dq(v_qt, policy.bits_v),
                             "batch", "kv_seq", "kv_heads", None)
            parts.append(seg.partial_attend(qg, keys, values, ok_q, scale,
                                            cfg.attn_softcap))
    if fp:
        parts.extend(fp_segment_partial(qg, cache, policy, lens, t_now,
                                        weff, scale, cfg.attn_softcap, dtype,
                                        extra_kv))
    return seg.finalize(parts).reshape(b, 1, hq, d).to(q.dtype), parts


def fp_segment_partial(qg, cache, policy: QuantPolicy, lens, t_now, weff,
                       scale: float, cap: float, dtype, extra_kv=None):
    """The fp sink + window-ring partial shared by both decode backends
    (DESIGN.md §1, §4), with the pre-append protocol's current token
    ``extra_kv = (k (B, 1, Hkv, D), v, pos (B,))`` as one more segment:
    ``[]`` when there is no fp segment."""
    b = qg.shape[0]
    ks, vs, pos, valid = [], [], [], []
    w, ns = policy.window, policy.n_sink
    if ns > 0 and "sink_k" in cache:
        ks.append(cache["sink_k"])
        vs.append(cache["sink_v"])
        p, st = seg.sink_segment(ns, lens)
        pos.append(seg.bcast_rows(p, b))
        valid.append(seg.bcast_rows(st, b))
    if w > 0 and "win_k" in cache:
        ks.append(cache["win_k"])
        vs.append(cache["win_v"])
        p, st = seg.window_segment(w, ns, lens)
        pos.append(seg.bcast_rows(p, b))
        valid.append(seg.bcast_rows(st, b))
    if extra_kv is not None:
        k1, v1, p1 = extra_kv
        ks.append(k1)
        vs.append(v1)
        p1 = torch.as_tensor(p1, device=qg.device).reshape(-1, 1)
        pos.append(seg.bcast_rows(p1.to(torch.int32), b))
        valid.append(torch.ones((b, 1), dtype=torch.bool,
                                device=qg.device))
    if not ks:
        return []
    kf = torch.cat(ks, dim=1).to(dtype)
    vf = torch.cat(vs, dim=1).to(dtype)
    ok = seg.attend_ok(torch.cat(pos, dim=1), torch.cat(valid, dim=1), t_now,
                       weff)
    return [seg.partial_attend(qg, kf, vf, ok, scale, cap)]
