"""SKVQ cache container, striped layout (port of ``repro.core.kv_cache``;
paper Sec. 3.2 + Alg. 1; DESIGN.md §1).

Token layout (absolute positions):

    [0, n_sink)                       fp sink buffer (kept forever)
    [n_sink, length - W)              packed quantized region
    [max(n_sink, length - W), length) fp sliding-window ring (last W tokens)

A cache is a plain dict of tensors with the reference's key names
(``length``, ``sink_k``, ``win_k``, ``qk_codes_hi``, ...), laid out
``(B, S, H_kv, ...)``; ``length`` is per-slot ``(B,)`` int32.

Unlike the reference, :func:`decode_append`,
:func:`prefill_chunk_append`, :func:`reset_slot`, :func:`insert_slot`,
:func:`pool_insert_blocks`, :func:`pool_copy_block` and
:func:`pool_write_blocks` update the tensors **in place** (and return the
same dict), so a layer's cache may be a view into a layer-stacked buffer.
:func:`prefill` allocates a fresh cache.

The pooled layout (DESIGN.md §9) keeps the packed planes in a shared pool
of physical blocks ``(NP + 1, BT, H_kv, ...)`` (block 0 is the never-read
null block) with a per-slot ``block_tbl`` ``(B, NB)`` int32; sinks, window
ring and length stay striped.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import segments as seg
from .policy import QuantPolicy, as_layer_policy, as_schedule
from .quant import dequantize_groups, quantize_groups, plane_layout

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


# ------------------------------------------------------- paged block pool

_PLANE_PREFIXES = ("qk_", "qv_")


def is_plane_key(key: str) -> bool:
    """True for packed-plane leaves (codes + scale/zero metadata): the only
    leaves that move into the shared pool (DESIGN.md §9)."""
    return key.startswith(_PLANE_PREFIXES)


def is_pooled(cache: Cache) -> bool:
    """True when the cache keeps its packed planes in a shared block pool
    (detected by the ``block_tbl`` leaf; DESIGN.md §9)."""
    return "block_tbl" in cache


def pooled_cache_shapes(batch: int, max_len: int, n_kv: int, head_dim: int,
                        policy: QuantPolicy, pool_blocks: int,
                        block_tokens: int, dtype=torch.bfloat16):
    """Dict of name -> (shape, dtype) for the pooled layout (DESIGN.md §9):
    :func:`cache_shapes` with the packed planes in a pool of
    ``pool_blocks`` blocks of ``block_tokens`` tokens (plus null block 0)
    and a ``block_tbl`` (batch, NB) logical -> physical map."""
    policy = as_layer_policy(policy)
    if policy.is_fp16:
        raise ValueError("fp16 policies have no packed planes to pool; "
                         "keep fp16 bands on the striped layout")
    w, ns = policy.window, policy.n_sink
    sq = max(0, max_len - ns - w)
    if sq == 0:
        raise ValueError(
            f"policy window={w} n_sink={ns} leaves no packed region at "
            f"max_len={max_len}; nothing to pool")
    nb = seg.n_table_blocks(sq, block_tokens)   # raises if sq is ragged
    if pool_blocks < 1:
        raise ValueError(f"pool_blocks must be >= 1, got {pool_blocks}")
    out = {"length": ((batch,), torch.int32),
           "block_tbl": ((batch, nb), torch.int32)}
    if ns > 0:
        out["sink_k"] = ((batch, ns, n_kv, head_dim), dtype)
        out["sink_v"] = ((batch, ns, n_kv, head_dim), dtype)
    if w > 0:
        out["win_k"] = ((batch, w, n_kv, head_dim), dtype)
        out["win_v"] = ((batch, w, n_kv, head_dim), dtype)
    gsz = min(policy.group_size, head_dim)
    for pref, bits in (("qk", policy.bits_k), ("qv", policy.bits_v)):
        for k, v in _qtensor_shapes(pool_blocks + 1, block_tokens, n_kv,
                                    head_dim, bits, gsz,
                                    policy.meta_dtype_bits).items():
            out[f"{pref}_{k}"] = v
    return out


def init_pooled_cache(batch, max_len, n_kv, head_dim, policy, pool_blocks,
                      block_tokens, dtype=torch.bfloat16, device=None
                      ) -> Cache:
    """Zero-filled pooled cache dict for one layer (DESIGN.md §9), on
    ``device`` (default CUDA; raises without a card unless ``"cpu"``)."""
    device = resolve_device(device)
    return {k: torch.zeros(s, dtype=d, device=device) for k, (s, d) in
            pooled_cache_shapes(batch, max_len, n_kv, head_dim, policy,
                                pool_blocks, block_tokens, dtype).items()}


def gather_blocks(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One pool-major plane (NP, BT, H, W) gathered through a block table
    (B, NB) into its striped view (B, NB*BT, H, W) (DESIGN.md §9)."""
    g = plane[table.long()]                             # (B, NB, BT, ...)
    return g.reshape((table.shape[0], table.shape[1] * g.shape[2])
                     + tuple(g.shape[3:]))


def unpool_cache(cache: Cache) -> Cache:
    """Gather a pooled cache into the equivalent striped view (DESIGN.md
    §9): planes (NP, BT, H, W) gathered through ``block_tbl`` (B, NB)
    become (B, NB*BT, H, W).  Unallocated entries gather the null block,
    whose contents lie past every slot's frontier and are masked."""
    tbl = cache["block_tbl"]
    return {key: gather_blocks(v, tbl) if is_plane_key(key) else v
            for key, v in cache.items() if key != "block_tbl"}


def _pairs(pairs, device) -> torch.Tensor:
    return torch.as_tensor(pairs, dtype=torch.int64,
                           device=device).reshape(-1, 2)


def pool_insert_blocks(dst: Cache, src: Cache, pairs, src_slot: int = 0,
                       pool_axis: int = 0) -> Cache:
    """In place: copy packed blocks of a striped cache into pool blocks
    (DESIGN.md §9).  ``pairs`` is (n, 2) rows of [logical_block,
    physical_block]: logical block ``lb`` of ``src`` row ``src_slot`` lands
    at pool block ``phys``; (0, 0) rows write the null block, a no-op.
    ``pool_axis`` is 0 for one layer, 1 for layer-stacked leaves."""
    sel = (slice(None),) * pool_axis
    for key, d in dst.items():
        if not is_plane_key(key):
            continue
        p = _pairs(pairs, d.device)
        bt = d.shape[pool_axis + 1]
        srow = src[key].select(pool_axis, src_slot)   # (..., sq_src, H, W)
        shp = tuple(srow.shape)
        nbs = shp[pool_axis] // bt
        blocks = srow.reshape(shp[:pool_axis] + (nbs, bt)
                              + shp[pool_axis + 1:])
        take = blocks.index_select(pool_axis, p[:, 0].clamp(0, nbs - 1))
        d[sel + (p[:, 1],)] = take.to(d.dtype)
    return dst


def pool_copy_block(cache: Cache, pairs, pool_axis: int = 0) -> Cache:
    """In place: copy pool blocks src -> dst across every plane leaf
    (DESIGN.md §9 copy-on-write); ``pairs`` is (n, 2) rows of [src_phys,
    dst_phys]."""
    sel = (slice(None),) * pool_axis
    for key, v in cache.items():
        if not is_plane_key(key):
            continue
        p = _pairs(pairs, v.device)
        v[sel + (p[:, 1],)] = v[sel + (p[:, 0],)]
    return cache


def _plane_items(cache: Cache):
    return [(k, v) for k, v in cache.items() if is_plane_key(k)]


def _block_layout(items, pool_axis: int):
    """(key, numpy dtype, per-block shape, bytes) of every plane leaf, in
    order: the byte layout of one block in a host staging row."""
    out = []
    for key, v in items:
        shape = tuple(v.shape[:pool_axis]) + tuple(v.shape[pool_axis + 1:])
        out.append((key, torch.empty((), dtype=v.dtype).numpy().dtype, shape,
                    math.prod(shape) * v.element_size()))
    return out


def pool_block_bytes(cache: Cache, pool_axis: int = 0) -> int:
    """Bytes of one physical block across every plane leaf (a staging
    row of :func:`pool_read_blocks`)."""
    return sum(nb for *_, nb in _block_layout(_plane_items(cache), pool_axis))


def pool_read_blocks(cache: Cache, phys, pool_axis: int = 0,
                     stage: Optional[torch.Tensor] = None) -> list:
    """Physical blocks ``phys`` of every packed-plane leaf, as host numpy
    arrays: one ``{plane_key: (..., BT, H, W)}`` dict per block, the pool
    axis removed (the leading layer axis of ``pool_axis=1`` leaves kept).
    The device->host read of the spill tier (DESIGN.md §11): the blocks of
    every leaf are gathered into one byte buffer on the device and cross
    to the host in ONE copy, into ``stage`` (a pinned uint8 buffer of at
    least ``len(phys) * pool_block_bytes`` bytes) when given, else into
    fresh pageable memory.  Each block then gets one host allocation of
    its own, which its leaves view."""
    items = _plane_items(cache)
    n = len(phys)
    if n == 0:
        return []
    idx = torch.as_tensor(list(phys), dtype=torch.int64,
                          device=items[0][1].device)
    sel = (slice(None),) * pool_axis
    flat = torch.cat([v[sel + (idx,)].movedim(pool_axis, 0).contiguous()
                      .view(torch.uint8).reshape(n, -1) for _, v in items],
                     dim=1)
    if stage is not None:
        host = stage[:flat.numel()].view(flat.shape)
        host.copy_(flat)
    else:
        host = flat.cpu()
    raw = host.numpy()
    layout = _block_layout(items, pool_axis)
    out = []
    for i in range(n):
        row = raw[i].copy()
        blk, off = {}, 0
        for key, dtype, shape, nb in layout:
            blk[key] = row[off:off + nb].view(dtype).reshape(shape)
            off += nb
        out.append(blk)
    return out


def pool_read_block(cache: Cache, phys: int, pool_axis: int = 0) -> dict:
    """One physical block of every packed-plane leaf as host numpy arrays
    (DESIGN.md §11; :func:`pool_read_blocks` of one block)."""
    return pool_read_blocks(cache, [phys], pool_axis)[0]


def pool_write_blocks(cache: Cache, blocks, phys, pool_axis: int = 0,
                      stage: Optional[torch.Tensor] = None) -> Cache:
    """In place: write host blocks (dicts as :func:`pool_read_blocks`
    returns them) back into physical blocks ``phys`` of every plane leaf,
    byte for byte: the host->device restore of the spill tier (DESIGN.md
    §11).  The blocks are packed into one host byte buffer (``stage``, a
    pinned uint8 buffer, when given) and cross in ONE host->device copy,
    synchronous, so the host buffer is free again on return; the leaves
    are written in place, so a captured graph's addresses hold."""
    items = _plane_items(cache)
    n = len(phys)
    if n == 0:
        return cache
    layout = _block_layout(items, pool_axis)
    width = sum(nb for *_, nb in layout)
    host = (stage[:n * width].view(n, width) if stage is not None
            else torch.empty((n, width), dtype=torch.uint8))
    raw = host.numpy()
    for i, blk in enumerate(blocks):
        off = 0
        for key, _, _, nb in layout:
            raw[i, off:off + nb] = np.ascontiguousarray(
                blk[key]).reshape(-1).view(np.uint8)
            off += nb
    dev = items[0][1].device
    buf = host.to(dev)
    idx = torch.as_tensor(list(phys), dtype=torch.int64, device=dev)
    sel = (slice(None),) * pool_axis
    off = 0
    for (key, v), (_, _, shape, nb) in zip(items, layout):
        leaf = buf[:, off:off + nb].contiguous().view(v.dtype)
        v[sel + (idx,)] = leaf.reshape((n,) + shape).movedim(0, pool_axis)
        off += nb
    return cache


def pool_write_block(cache: Cache, block: dict, phys: int,
                     pool_axis: int = 0) -> Cache:
    """In place: restore one spilled block into physical block ``phys``
    (DESIGN.md §11; :func:`pool_write_blocks` of one block)."""
    return pool_write_blocks(cache, [block], [phys], pool_axis)


def pool_block_nbytes(n_kv: int, head_dim: int, policy: QuantPolicy,
                      block_tokens: int) -> int:
    """Exact bytes of ONE pool block for one layer (codes + scale/zero of
    both K and V), straight from :func:`_qtensor_shapes` (DESIGN.md §9)."""
    policy = as_layer_policy(policy)
    if policy.is_fp16:
        raise ValueError("fp16 policies have no packed planes")
    gsz = min(policy.group_size, head_dim)
    total = 0
    for bits in (policy.bits_k, policy.bits_v):
        for (s, d) in _qtensor_shapes(1, block_tokens, n_kv, head_dim, bits,
                                      gsz, policy.meta_dtype_bits).values():
            total += math.prod(s) * torch.empty((), dtype=d).element_size()
    return total


def slot_lengths(cache: Cache, batch: Optional[int] = None) -> torch.Tensor:
    """Per-slot lengths (B,) (DESIGN.md §6).  A scalar length broadcasts;
    pooled plane leaves lead with the pool axis, so batch comes from a
    per-slot leaf."""
    t = cache["length"]
    if t.ndim == 0:
        if batch is None:
            batch = next(v.shape[0] for k, v in cache.items()
                         if k != "length" and not is_plane_key(k))
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


def _pool_dest(tbl: torch.Tensor, idx: torch.Tensor, block_tokens: int,
               cond: torch.Tensor):
    """Pooled write target (DESIGN.md §9): packed index ``idx`` (B,) routes
    through the slot's table to (physical block, offset) index tensors.
    Rows with ``cond`` False are steered to null block 0, which is never
    read unmasked; copy-on-write makes live rows own their target block,
    so live writes never collide.  Computed once per append and shared by
    every plane leaf."""
    lb = torch.div(idx, block_tokens, rounding_mode="floor").clamp(
        0, tbl.shape[1] - 1)
    phys = seg.physical_block(tbl, lb)
    p = torch.where(cond, phys, torch.zeros_like(phys))
    return p.long(), torch.remainder(idx, block_tokens).long()


# ------------------------------------------------------ slot lifecycle ops

def reset_slot(caches, i: int, batch_axis: int = 0):
    """In place: zero batch slot ``i`` of every leaf (DESIGN.md §6
    retirement).  Works on one cache dict or nested groups of
    layer-stacked caches (``batch_axis=1``).  A pooled cache (§9) zeroes
    the slot's ``block_tbl`` row but leaves the shared planes alone: other
    slots may share those blocks, and freeing them is the host
    ``BlockPool``'s job."""
    if isinstance(caches, dict):
        pooled = is_pooled(caches)
        for k, v in caches.items():
            if not (pooled and is_plane_key(k)):
                reset_slot(v, i, batch_axis)
        return caches
    caches.select(batch_axis, i).zero_()
    return caches


def insert_slot(dst, i: int, src, src_slot: int = 0, batch_axis: int = 0):
    """In place: copy batch row ``src_slot`` of ``src`` into slot ``i`` of
    ``dst`` (DESIGN.md §6 admission).  Non-batch dims must match.  When
    ``dst`` is pooled (§9) only the striped leaves copy; the planes land
    through :func:`pool_insert_blocks` and ``block_tbl`` is the host
    pool's."""
    if isinstance(dst, dict):
        pooled = is_pooled(dst)
        for k, v in dst.items():
            if not (pooled and (is_plane_key(k) or k == "block_tbl")):
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
                  valid: Optional[torch.Tensor] = None,
                  packed_span: Optional[Tuple[int, int]] = None) -> Cache:
    """In place: append one token (k/v_new: (B, 1, H_kv, D)) per slot and
    quantize the token it evicts from the window (DESIGN.md §1).

    Every row advances at its own ``length``.  Rows with ``valid`` False
    (optional (B,) bool) are no-ops and do not advance.  A pooled cache
    (§9) routes the packed write through the slot's block table
    (:func:`_pool_dest`).  ``packed_span`` ``(offset, total)``: the
    striped planes hold packed tokens ``[offset, offset + S)`` of a
    region of ``total`` (a rank's shard of a context-parallel cache): the
    packed write lands only where its global index falls in the shard.
    Returns ``cache``."""
    policy = as_layer_policy(policy)
    qf = quant_fn or quantize_groups
    b, _, h, d = k_new.shape
    w, ns = policy.window, policy.n_sink
    t = slot_lengths(cache, b).clone()
    ok = (torch.ones(b, dtype=torch.bool, device=k_new.device) if valid is None
          else torch.as_tensor(valid, device=k_new.device).expand(b))
    pooled = is_pooled(cache)

    def packed_len():
        s = cache["qk_codes_hi"].shape[1]
        if packed_span is not None:
            return packed_span[1]
        return cache["block_tbl"].shape[-1] * s if pooled else s

    def put_all(qk, qv, idx, cond):
        if packed_span is not None:
            n = cache["qk_codes_hi"].shape[1]
            idx = idx - packed_span[0]
            cond = cond & (idx >= 0) & (idx < n)
            idx = idx.clamp(0, n - 1)
        if pooled:
            dest = _pool_dest(cache["block_tbl"], idx,
                              cache["qk_codes_hi"].shape[1], cond)
        for name, qt in (("qk", qk), ("qv", qv)):
            for kk, vv in qt.items():
                full = cache[f"{name}_{kk}"]
                if pooled:
                    full[dest] = vv[:, 0].to(full.dtype)
                else:
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
            idx = u_e.clamp(0, packed_len() - 1)
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
        idx = (t - ns).clamp_min(0).clamp_max(packed_len() - 1)
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


def prefill_chunk_append(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                         policy: QuantPolicy, n_valid,
                         alpha_k: Optional[torch.Tensor] = None,
                         alpha_v: Optional[torch.Tensor] = None,
                         quant_fn: Optional[QuantFn] = None) -> Cache:
    """In place: append a prefill chunk (k/v (B, C, H_kv, D)) token by
    token through :func:`decode_append` (DESIGN.md §7), so every chunk
    token follows the decode protocol: it enters the sinks or the window,
    and the token it evicts is quantized into its packed slot.  Per-token
    group quantization makes each packed row independent of when it was
    quantized.  ``n_valid`` (scalar or (B,)): real tokens in the chunk;
    slots at or past it are bucket padding and append nothing.

    An fp16 policy writes the chunk in bulk (:func:`_fp16_chunk_write`),
    the token loop's result without the loop."""
    b, c = k.shape[:2]
    nv = torch.as_tensor(n_valid, device=k.device).expand(b)
    if as_layer_policy(policy).is_fp16:
        return _fp16_chunk_write(cache, k, v, nv)
    _, valid = seg.chunk_segment(0, nv, c, device=k.device)    # (B, C)
    for i in range(c):
        decode_append(cache, k[:, i:i + 1], v[:, i:i + 1], policy, alpha_k,
                      alpha_v, quant_fn=quant_fn, valid=valid[:, i])
    return cache


def _fp16_chunk_write(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                      nv: torch.Tensor) -> Cache:
    """In place: chunk token ``i`` of row ``b`` to cache row ``length[b] +
    i`` of ``k``/``v`` for ``i < nv[b]``, then ``length += nv``: a gather
    over the whole buffer (every row written at most once, no duplicate
    index, no host read), equal to :func:`decode_append`'s fp16 branch
    applied token by token."""
    b, c = k.shape[:2]
    t = slot_lengths(cache, b)
    s = cache["k"].shape[1]
    i = torch.arange(s, device=k.device)[None, :] - t[:, None].long()
    take = ((i >= 0) & (i < nv[:, None]))[..., None, None]     # (B, S, 1, 1)
    idx = i.clamp(0, c - 1)[..., None, None].expand(
        (b, s) + tuple(k.shape[2:]))
    for buf, x in (("k", k), ("v", v)):
        src = torch.gather(x.to(cache[buf].dtype), 1, idx)
        cache[buf].copy_(torch.where(take, src, cache[buf]))
    cache["length"].copy_(t + nv.to(t.dtype))
    return cache


# ----------------------------------------------------------- attention inputs

def gather_attention_inputs(cache: Cache, head_dim: int, policy: QuantPolicy,
                            dtype=torch.bfloat16):
    """Reference path: every stored token as (K, V, positions, valid)
    (DESIGN.md §1).  K/V (B, T, H, D) in ``dtype``, positions (B, T)
    int32, valid (B, T) bool, T = n_sink + S_q + W, in the segment order
    ``[sinks, packed, window]`` of :mod:`.segments`; per slot, since each
    row sits at its own ``length``.  A pooled cache (§9) is gathered into
    its striped view first (:func:`unpool_cache`), so both layouts give
    the same inputs.  The decode kernel reads the packed planes
    directly instead."""
    if is_pooled(cache):
        cache = unpool_cache(cache)
    policy = as_layer_policy(policy)
    w, ns = policy.window, policy.n_sink
    t_total = slot_lengths(cache)
    b = t_total.shape[0]
    gsz = min(policy.group_size, head_dim)
    ks, vs, pos, val = [], [], [], []

    def push(p, stored):
        pos.append(seg.bcast_rows(p, b))
        val.append(seg.bcast_rows(stored, b))

    if ns > 0:
        ks.append(cache["sink_k"].to(dtype))
        vs.append(cache["sink_v"].to(dtype))
        push(*seg.sink_segment(ns, t_total))
    if "qk_codes_hi" in cache and cache["qk_codes_hi"].shape[1] > 0:
        kq = dequantize_groups(
            {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")},
            head_dim, policy.bits_k, gsz, policy.fp8_meta, dtype)
        vq = dequantize_groups(
            {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")},
            head_dim, policy.bits_v, gsz, policy.fp8_meta, dtype)
        ks.append(kq)
        vs.append(vq)
        j = torch.arange(kq.shape[1], dtype=torch.int32, device=kq.device)
        push(*seg.packed_segment(j, t_total, ns, w))
    if w > 0:
        ks.append(cache["win_k"].to(dtype))
        vs.append(cache["win_v"].to(dtype))
        push(*seg.window_segment(w, ns, t_total))
    return (torch.cat(ks, dim=1), torch.cat(vs, dim=1),
            torch.cat(pos, dim=1), torch.cat(val, dim=1))


def materialize_kv(cache: Cache, head_dim: int, policy: QuantPolicy,
                   total_len: int, dtype=torch.float32):
    """Test and quality helper: K/V (B, total_len, H, D) in absolute
    position order, inverting the segment layout of DESIGN.md §1 (positions
    nothing stores stay 0)."""
    k, v, pos, valid = gather_attention_inputs(cache, head_dim, policy, dtype)
    b, _, h, d = k.shape
    # one extra "dump" row takes the invalid entries; valid positions are
    # unique within a row, so the scatter has no conflicting writes
    safe = torch.where(valid, pos.long(), torch.full_like(pos.long(),
                                                          total_len))
    rows = torch.arange(b, device=k.device)[:, None]
    out = []
    for x in (k, v):
        buf = torch.zeros((b, total_len + 1, h, d), dtype=dtype,
                          device=x.device)
        buf[rows, safe] = x.to(dtype)
        out.append(buf[:, :total_len])
    return out[0], out[1]


# --------------------------------------------------------- byte accounting

def policy_cache_nbytes(max_len: int, n_kv: int, head_dim: int,
                        policy: QuantPolicy, dtype=torch.bfloat16) -> int:
    """Exact bytes of one layer's cache at capacity ``max_len`` (batch 1),
    straight from :func:`cache_shapes` (DESIGN.md §8)."""
    shapes = cache_shapes(1, max_len, n_kv, head_dim, policy, dtype)
    return sum(math.prod(s) * torch.empty((), dtype=d).element_size()
               for name, (s, d) in shapes.items() if name != "length")


def schedule_cache_nbytes(schedule, n_layers: int, max_len: int, n_kv: int,
                          head_dim: int, dtype=torch.bfloat16):
    """Per-layer cache bytes of a whole schedule (policy, schedule or
    preset): one :func:`policy_cache_nbytes` entry per layer (DESIGN.md §8
    accounting; ``Engine.backend_info`` and the serve CLI read it)."""
    sched = as_schedule(schedule, n_layers)
    per_policy = {p: policy_cache_nbytes(max_len, n_kv, head_dim, p, dtype)
                  for p in sched.distinct()}
    return tuple(per_policy[p] for p in sched.layers)
