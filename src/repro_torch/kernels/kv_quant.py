"""Fused clipped group-quantize + bit-pack (port of the TPU kernel
``kv_quant_pallas``, ``src/repro/kernels/kv_quant.py``), and the fused
decode append built on it.

Both entry points of ``csrc/kv_quant.cu`` share one warp-level row
quantizer:

* :func:`kv_quant` — bulk rows (prefill): launches the kernel on CUDA
  tensors and takes the plain PyTorch version :func:`kv_quant_plain` only
  for CPU tensors.  Both are bytes-for-bytes equal to
  ``core.quant.quantize_groups`` — including the ±448 saturation of FP8
  metadata, which the Pallas kernel lacks — so caches built either way are
  interchangeable.
* :func:`kv_append` — ``kv_cache.decode_append`` of one layer in ONE
  launch (ring-slot read, quantize + pack of the evicted token, the packed
  write striped or through the block table, ring/sink write, ``length``
  update), reading ``length`` on the device, so it is capturable in a CUDA
  graph.  CPU tensors take :func:`kv_append_plain`, which IS
  ``decode_append`` with the plain quantizer.
* :func:`kv_append_chunk` — ``kv_cache.prefill_chunk_append`` of a
  chunked-prefill chunk (DESIGN.md §7) as bulk gathers and writes around
  ONE bulk ``kv_quant`` launch per plane (K, V) per layer, instead of a
  launch per token; CPU tensors take :func:`kv_append_chunk_plain`, the
  token loop.

What bounds each on an H100, and the design: see the note at the top of
``csrc/kv_quant.cu``.  The append's argument checks, which need no card,
live in :func:`append_launch_args`.

``LAUNCHES["kernel"]`` / ``["plain"]`` count bulk kernel launches / plain
calls; ``LAUNCHES["append"]`` / ``["append_plain"]`` the same for the
append; ``LAUNCHES["chunk_plain"]`` counts plain chunk appends (the chunk
append's kernel launches are the bulk ones).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from ..core.kv_cache import decode_append, is_pooled, prefill_chunk_append
from ..core.policy import QuantPolicy, as_layer_policy
from ..core.quant import (n_meta_groups, packed_nbytes, plane_layout,
                          quantize_groups)
from ..launch import op_cost

LAUNCHES = {"kernel": 0, "plain": 0, "append": 0, "append_plain": 0,
            "chunk_plain": 0}
_C = ctypes
_FP_DTYPES = (torch.float32, torch.bfloat16)
ROW_MAX = 256  # the widest row the kernel takes (``make_layout``)


def _alpha_rows(alpha, n: int):
    """(P, G) clip factors with P dividing n -> (n, G): row r takes
    alpha[r % P], the kernel's reading."""
    if torch.is_tensor(alpha) and alpha.ndim == 2 and alpha.shape[0] != n:
        return alpha.repeat(n // alpha.shape[0], 1)
    return alpha


def kv_quant_plain(x: torch.Tensor, bits: float, group_size: int,
                   alpha: Optional[torch.Tensor] = None,
                   fp8_meta: bool = True) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: ``quantize_groups`` on any device."""
    LAUNCHES["plain"] += 1
    return quantize_groups(x, bits, group_size, _alpha_rows(alpha, x.shape[0]),
                           fp8_meta)


def lane_channels(d: int) -> int:
    """Channels per lane of the row quantizer's general form: 4, or 8
    above 128 so that a row spans at most a warp (``general_cpl`` in the
    source)."""
    return 8 if d > 128 else 4


def kernel_layout(d: int, bits: float, group_size: int
                  ) -> List[Tuple[int, int, int, int]]:
    """``plane_layout`` of a row the kernel takes, or ValueError: D up to
    ``ROW_MAX`` with a power-of-two count of lanes (``lane_channels``) per
    row; planes of 1/2/4/8-bit codes in whole lanes (whole bytes at 1 bit);
    each group a power-of-two run of lanes starting at a multiple of its
    length.  Mirrors ``make_layout`` in the source."""
    cpl = lane_channels(d)
    lanes = d // cpl
    if d <= 0 or d > ROW_MAX or d % cpl or lanes & (lanes - 1):
        raise ValueError(f"kv_quant kernel: head dim {d} is not a power-of-"
                         f"two multiple of {cpl} channels up to {ROW_MAX}")
    layout = plane_layout(d, bits, group_size)
    for start, width, b, gs in layout:
        gl = gs // cpl
        if (start % cpl or width % cpl or gs % cpl or gl & (gl - 1)
                or start % gs or width % gs or b not in (1, 2, 4, 8)
                or (cpl * b < 8 and (start % 8 or width % 8))):
            raise ValueError(
                f"kv_quant kernel: unsupported group {gs} (plane at channel "
                f"{start}, width {width}, {b}-bit) of a {d}-channel row: "
                f"groups must be power-of-two runs of {cpl}-channel lanes")
    return layout


def _planes_args(layout, outs) -> Tuple[object, object]:
    """C arrays of plane ints {start, width, bits, gs} and pointers {codes,
    scale, zero}, one (codes, scale, zero) triple of ``outs`` a plane."""
    ints, ptrs = [], []
    for (start, width, b, gs), (c, s, z) in zip(layout, outs):
        ints += [start, width, b, gs]
        ptrs += [c.data_ptr(), s.data_ptr(), z.data_ptr()]
    return (_C.c_int * len(ints))(*ints), (_C.c_void_p * len(ptrs))(*ptrs)


def _aligned(t: torch.Tensor, nbytes: int, what: str) -> None:
    if t.data_ptr() % nbytes:
        raise ValueError(f"{what}: data must be {nbytes}-byte aligned")


def _check_alpha(alpha, g_total: int, period_of: int, device, what: str):
    """alpha -> (contiguous f32 tensor or None, period): None; (G,) shared
    (period 0); (P, G) with ``period_of`` % P == 0, row r reading alpha[r %
    P]."""
    if alpha is None:
        return None, 0
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    if alpha.ndim <= 1:
        if alpha.numel() not in (1, g_total):
            raise ValueError(f"{what}: shared alpha must have {g_total} "
                             f"entries, got {tuple(alpha.shape)}")
        return alpha.expand(g_total).contiguous(), 0
    if (alpha.ndim != 2 or alpha.shape[1] != g_total or alpha.shape[0] < 1
            or period_of % alpha.shape[0]):
        raise ValueError(f"{what}: alpha must be ({g_total},) or (P, "
                         f"{g_total}) with P dividing {period_of}, got "
                         f"{tuple(alpha.shape)}")
    if not alpha.is_contiguous():
        raise ValueError(f"{what}: alpha must be contiguous")
    return alpha, alpha.shape[0]


def _lib(name: str):
    fn = getattr(_build.load("kv_quant"), name)
    if fn.argtypes is None:
        p, i = _C.c_void_p, _C.c_int
        fn.argtypes = ([p, i, i, i, p, i, i, p, p, i, p]
                       if name == "kv_quant_launch" else
                       [i, i, i, p, p, i, i, i, p, p, i, p, p, i, p])
        fn.restype = _C.c_int
    return fn


def quant_cost(x: torch.Tensor, bits: float, group_size: int,
               fp8_meta: bool = True) -> Tuple[float, float]:
    """(f32 operations, bytes) of one bulk launch: the rows read once and
    their packed codes and scale/zero written once; 7 operations an
    element (PERF.md §6's bound of the kernel)."""
    d = x.shape[-1]
    n = x.numel() // d
    out = n * packed_nbytes(d, bits, min(group_size, d), 8 if fp8_meta
                            else 16)
    return 7.0 * x.numel(), float(x.numel() * x.element_size() + out)


def kv_quant(x: torch.Tensor, bits: float, group_size: int,
             alpha: Optional[torch.Tensor] = None,
             fp8_meta: bool = True) -> Dict[str, torch.Tensor]:
    """See :func:`_kv_quant`; reports :func:`quant_cost` to an active
    ``launch.op_cost`` counter."""
    with op_cost.kernel_cost("kv_quant", lambda: quant_cost(
            x, bits, group_size, fp8_meta)):
        return _kv_quant(x, bits, group_size, alpha, fp8_meta)


def _kv_quant(x: torch.Tensor, bits: float, group_size: int,
              alpha: Optional[torch.Tensor] = None,
              fp8_meta: bool = True) -> Dict[str, torch.Tensor]:
    """x (N, D) tokens -> QTensor dict in the ``core.quant`` layout.

    ``alpha``: None, (G_total,) shared, or (P, G_total) clip factors with
    P dividing N, row r reading alpha[r % P] — (N, G_total) per row, or
    (H, G_total) per head for rows flattened from (..., H, D) without a
    tiled copy.  CUDA tensors launch the kernel (and raise if it fails);
    CPU tensors take :func:`kv_quant_plain`."""
    if x.device.type == "cpu":
        return kv_quant_plain(x, bits, group_size, alpha, fp8_meta)
    if x.device.type != "cuda":
        raise ValueError(f"kv_quant: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"kv_quant wants (N, D) rows, got {tuple(x.shape)}")
    n, d = x.shape
    if n >= 2 ** 30:
        raise ValueError(f"kv_quant: {n} rows is too many for one launch")
    layout = kernel_layout(d, bits, group_size)
    if x.dtype not in _FP_DTYPES:
        x = x.to(torch.float32)
    x = x.contiguous()
    _aligned(x, 16, "kv_quant x")
    alpha, period = _check_alpha(alpha, sum(w // gs for (_, w, _, gs)
                                            in layout), n, x.device,
                                 "kv_quant")
    meta_dt = torch.uint8 if fp8_meta else torch.float16
    out, planes = {}, []
    for name, (start, width, b, gs) in zip(("hi", "lo"), layout):
        codes = torch.empty((n, width * b // 8), dtype=torch.uint8,
                            device=x.device)
        scale = torch.empty((n, width // gs), dtype=meta_dt, device=x.device)
        zero = torch.empty((n, width // gs), dtype=meta_dt, device=x.device)
        out.update({f"codes_{name}": codes, f"scale_{name}": scale,
                    f"zero_{name}": zero})
        planes.append((codes, scale, zero))
    ints, ptrs = _planes_args(layout, planes)
    rc = _lib("kv_quant_launch")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), n, d,
        None if alpha is None else alpha.data_ptr(), period, len(layout),
        ints, ptrs, int(fp8_meta),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "kv_quant")
    LAUNCHES["kernel"] += 1
    return out


# ------------------------------------------------------------ decode append

def kv_append_plain(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                    policy: QuantPolicy, alpha_k=None, alpha_v=None,
                    valid=None):
    """Plain version of :func:`kv_append`: ``kv_cache.decode_append`` with
    the plain quantizer, in place, on any device."""
    LAUNCHES["append_plain"] += 1
    return decode_append(cache, k_new, v_new, policy, alpha_k, alpha_v,
                         quant_fn=None, valid=valid)


def _leaf(cache, key: str, shape, dtype, device) -> torch.Tensor:
    t = cache[key]
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"kv_append: cache[{key!r}] is {tuple(t.shape)} "
                         f"{t.dtype}, expected {tuple(shape)} {dtype}")
    if t.device != device:
        raise ValueError(f"kv_append: cache[{key!r}] is on {t.device}, "
                         f"k_new on {device}")
    if not t.is_contiguous():
        raise ValueError(f"kv_append: cache[{key!r}] is not contiguous "
                         f"(the kernel writes it in place by flat index)")
    return t


def append_launch_args(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                       policy: QuantPolicy, alpha_k=None, alpha_v=None,
                       valid=None) -> dict:
    """Checks of an append launch that need no card (dtypes, shapes,
    contiguity, alpha, the block table, the plane layout); returns the
    launch's ints and tensors.  Raises NotImplementedError for an fp16
    policy (nothing to quantize: the card path has no such mode) and
    ValueError for anything the kernel does not take."""
    policy = as_layer_policy(policy)
    if policy.is_fp16:
        raise NotImplementedError(
            "kv_append: an fp16 policy has nothing to quantize; the kernel "
            "has no fp16 mode (use kv_cache.decode_append off the card)")
    if k_new.ndim != 4 or k_new.shape[1] != 1 or v_new.shape != k_new.shape:
        raise ValueError(f"kv_append wants k_new/v_new (B, 1, H, D), got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    b, _, h, d = k_new.shape
    dt, dev = k_new.dtype, k_new.device
    if dt not in _FP_DTYPES or v_new.dtype != dt:
        raise ValueError(f"kv_append: k_new/v_new must share f32 or bf16, "
                         f"got {k_new.dtype} / {v_new.dtype}")
    if v_new.device != dev or not (k_new.is_contiguous()
                                   and v_new.is_contiguous()):
        raise ValueError("kv_append: k_new/v_new must be contiguous on one "
                         "device")
    w, ns = policy.window, policy.n_sink
    gsz = min(policy.group_size, d)
    cpl = lane_channels(d)
    pooled = is_pooled(cache)
    t = {"length": _leaf(cache, "length", (b,), torch.int32, dev)}
    for key, n_tok in (("sink", ns), ("win", w)):
        for kv in ("k", "v"):
            if n_tok > 0:
                t[f"{key}_{kv}"] = _leaf(cache, f"{key}_{kv}",
                                         (b, n_tok, h, d), dt, dev)
    rows = cache["qk_codes_hi"].shape[:2]
    if pooled:
        nb = cache["block_tbl"].shape[-1]
        t["block_tbl"] = _leaf(cache, "block_tbl", (b, nb), torch.int32, dev)
        n_phys, bt = rows
        cap = nb * bt
    else:
        if rows[0] != b:
            raise ValueError(f"kv_append: planes hold {rows[0]} slots, "
                             f"k_new {b}")
        nb = n_phys = bt = 0
        cap = rows[1]
    if w == 0 and cap == 0:
        raise ValueError("kv_append: no window and no packed region")
    meta_dt = torch.uint8 if policy.fp8_meta else torch.float16
    planes, alphas = {}, {}
    for pref, bits, alpha in (("qk", policy.bits_k, alpha_k),
                              ("qv", policy.bits_v, alpha_v)):
        layout = kernel_layout(d, bits, gsz)
        outs = []
        for name, (_, width, pb, gs) in zip(("hi", "lo"), layout):
            lead = tuple(rows) + (h,)
            c = _leaf(cache, f"{pref}_codes_{name}", lead + (width * pb // 8,),
                      torch.uint8, dev)
            s = _leaf(cache, f"{pref}_scale_{name}", lead + (width // gs,),
                      meta_dt, dev)
            z = _leaf(cache, f"{pref}_zero_{name}", lead + (width // gs,),
                      meta_dt, dev)
            _aligned(c, min(8, max(1, cpl * pb // 8)),
                     f"kv_append {pref}_codes_{name}")
            outs.append((c, s, z))
        planes[pref] = (layout, outs)
        g_total = sum(wd // gs for (_, wd, _, gs) in layout)
        alphas[pref] = _check_alpha(alpha, g_total, h, dev,
                                    f"kv_append alpha_{pref[1]}")
    row_align = min(16, cpl * k_new.element_size())
    for key in ("sink_k", "sink_v", "win_k", "win_v"):
        if key in t:
            _aligned(t[key], row_align, f"kv_append {key}")
    _aligned(k_new, row_align, "kv_append k_new")
    _aligned(v_new, row_align, "kv_append v_new")
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool,
                                device=dev).expand(b).contiguous()
    return {"b": b, "d": d, "dims": (h, w, ns, cap, bt, nb, n_phys),
            "tensors": t, "valid": valid, "k_new": k_new, "v_new": v_new,
            "planes": planes, "alphas": alphas,
            "bf16": dt == torch.bfloat16, "fp8": policy.fp8_meta}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _lengths(t: torch.Tensor):
    """The values of a small int tensor on the host, or None for one
    without values (fake or meta)."""
    try:
        return t.tolist()
    except Exception:            # a fake or meta tensor has no values
        return None


def append_cost(cache, k_new: torch.Tensor, policy: QuantPolicy
                ) -> Tuple[float, float]:
    """(f32 operations, bytes) of one append launch at the cache's
    lengths (read back): per slot and head the new K/V rows read and
    written (ring or sink), and for each slot that evicts the ring rows
    read and the packed rows written (and its table entry if pooled); the
    lengths and the clip factors once; 7 operations an element quantized
    (PERF.md §6's bound of the kernel; every slot evicts where the
    lengths have no values)."""
    policy = as_layer_policy(policy)
    b, _, hkv, d = k_new.shape
    gsz = min(policy.group_size, d)
    bits = policy.meta_dtype_bits
    packed = (packed_nbytes(d, policy.bits_k, gsz, bits)
              + packed_nbytes(d, policy.bits_v, gsz, bits))
    row = 2 * d * k_new.element_size()               # K + V rows
    lens = _lengths(cache["length"])
    n_ev = b if lens is None else sum(
        1 for t in lens if t - policy.n_sink - policy.window >= 0)
    nbytes = (b * hkv * 2 * row + n_ev * hkv * (row + packed)
              + n_ev * 4 * ("block_tbl" in cache) + 8 * b
              + 4 * hkv * (n_meta_groups(d, policy.bits_k, gsz)
                           + n_meta_groups(d, policy.bits_v, gsz)))
    return 7.0 * 2 * n_ev * hkv * d, float(nbytes)


def kv_append(cache, k_new: torch.Tensor, v_new: torch.Tensor,
              policy: QuantPolicy, alpha_k=None, alpha_v=None, valid=None):
    """See :func:`_kv_append`; reports :func:`append_cost` to an active
    ``launch.op_cost`` counter."""
    with op_cost.kernel_cost("kv_append", lambda: append_cost(
            cache, k_new, policy)):
        return _kv_append(cache, k_new, v_new, policy, alpha_k, alpha_v,
                          valid)


def _kv_append(cache, k_new: torch.Tensor, v_new: torch.Tensor,
               policy: QuantPolicy, alpha_k=None, alpha_v=None, valid=None):
    """In place: append one token per slot (k/v_new (B, 1, H, D)) and
    quantize the token it evicts from the window — ``decode_append``'s
    semantics (striped or pooled cache; ``valid`` (B,) bool rows only;
    alpha (H, G_total) per head or (G_total,) shared).  CUDA tensors launch
    the kernel once (and raise if it fails; an fp16 policy raises); CPU
    tensors take :func:`kv_append_plain`.  Returns ``cache``."""
    if k_new.device.type == "cpu":
        return kv_append_plain(cache, k_new, v_new, policy, alpha_k, alpha_v,
                               valid)
    if k_new.device.type != "cuda":
        raise ValueError(f"kv_append: unsupported device {k_new.device}")
    a = append_launch_args(cache, k_new, v_new, policy, alpha_k, alpha_v,
                           valid)
    t = a["tensors"]
    (ak, ak_p), (av, av_p) = a["alphas"]["qk"], a["alphas"]["qv"]
    ptrs = [t["length"], a["valid"], t.get("block_tbl"), a["k_new"],
            a["v_new"], t.get("win_k"), t.get("win_v"), t.get("sink_k"),
            t.get("sink_v"), ak, av]
    k_ints, k_ptrs = _planes_args(*a["planes"]["qk"])
    v_ints, v_ptrs = _planes_args(*a["planes"]["qv"])
    rc = _lib("kv_append_launch")(
        int(a["bf16"]), a["b"], a["d"], (_C.c_int * 7)(*a["dims"]),
        (_C.c_void_p * 11)(*[_ptr(p) for p in ptrs]), ak_p, av_p,
        len(a["planes"]["qk"][0]), k_ints, k_ptrs,
        len(a["planes"]["qv"][0]), v_ints, v_ptrs, int(a["fp8"]),
        torch.cuda.current_stream(k_new.device).cuda_stream)
    _build.check(rc, "kv_append")
    LAUNCHES["append"] += 1
    return cache


# ------------------------------------------------------ chunk append

def kv_append_chunk_plain(cache, k: torch.Tensor, v: torch.Tensor,
                          policy: QuantPolicy, t0: int, n_valid: int,
                          alpha_k=None, alpha_v=None):
    """Plain version of :func:`kv_append_chunk`: the token loop
    ``kv_cache.prefill_chunk_append`` with the plain quantizer, in place,
    on any device (``t0`` is implied by ``cache["length"]``)."""
    LAUNCHES["chunk_plain"] += 1
    return prefill_chunk_append(cache, k, v, policy, n_valid, alpha_k,
                                alpha_v)


def chunk_evictions(policy: QuantPolicy, t0: int, n_valid: int
                    ) -> Tuple[int, int]:
    """Absolute positions ``[lo, hi)`` that appending tokens ``[t0, t0 +
    n_valid)`` quantizes into the packed region: the tokens they push out
    of the window, or (no window) the non-sink tokens themselves; empty
    when ``lo >= hi``."""
    policy = as_layer_policy(policy)
    w, ns = policy.window, policy.n_sink
    return max(ns, t0 - w), t0 + n_valid - w


def chunk_cost(k: torch.Tensor, policy: QuantPolicy, t0: int, n_valid: int
               ) -> Tuple[float, float]:
    """(f32 operations, bytes) of one chunk append: the evicted rows read
    once (ring or chunk) and their packed rows written, the chunk rows
    that land in the ring or the sinks read and written, the clip
    factors; 7 operations an element quantized (PERF.md §6's bound)."""
    policy = as_layer_policy(policy)
    hkv, d = k.shape[2], k.shape[3]
    lo, hi = chunk_evictions(policy, int(t0), int(n_valid))
    n_ev = max(0, hi - lo)
    end = int(t0) + int(n_valid)
    n_fp = max(0, min(policy.n_sink, end) - int(t0)) + max(
        0, end - max(policy.n_sink, end - policy.window, int(t0)))
    gsz = min(policy.group_size, d)
    bits = policy.meta_dtype_bits
    row = 2 * hkv * d * k.element_size()             # K + V rows
    packed = hkv * (packed_nbytes(d, policy.bits_k, gsz, bits)
                    + packed_nbytes(d, policy.bits_v, gsz, bits))
    nbytes = (n_ev * (row + packed) + 2 * n_fp * row + 4 * hkv
              * (n_meta_groups(d, policy.bits_k, gsz)
                 + n_meta_groups(d, policy.bits_v, gsz)))
    return 7.0 * 2 * n_ev * hkv * d, float(nbytes)


def kv_append_chunk(cache, k: torch.Tensor, v: torch.Tensor,
                    policy: QuantPolicy, t0: int, n_valid: int,
                    alpha_k=None, alpha_v=None, quant_fn=None):
    """See :func:`_kv_append_chunk`; reports :func:`chunk_cost` to an
    active ``launch.op_cost`` counter."""
    with op_cost.kernel_cost("kv_append_chunk", lambda: chunk_cost(
            k, policy, t0, n_valid)):
        return _kv_append_chunk(cache, k, v, policy, t0, n_valid, alpha_k,
                                alpha_v, quant_fn)


def _kv_append_chunk(cache, k: torch.Tensor, v: torch.Tensor,
                     policy: QuantPolicy, t0: int, n_valid: int,
                     alpha_k=None, alpha_v=None, quant_fn=None):
    """In place: append tokens ``[t0, t0 + n_valid)`` of a prefill chunk
    (k/v (1, C, H, D), rows past ``n_valid`` bucket padding) to a batch-1
    striped cache at length ``t0`` — the token loop's result
    (:func:`kv_append_chunk_plain`) byte for byte, by bulk writes:

    1. gather the rows the chunk evicts, in position order
       (:func:`chunk_evictions`): positions before ``t0`` from the ring at
       slot ``(p - n_sink) % window``, later ones from the chunk — before
       the ring is overwritten;
    2. quantize them with ONE bulk ``kv_quant`` launch per plane (K, V)
       with the per-head clip factors; a chunk that evicts nothing
       launches nothing;
    3. write the packed rows to the contiguous range ``[lo - n_sink, hi -
       n_sink)``;
    4. write the last ``min(window, ·)`` chunk tokens to the ring, any
       before ``n_sink`` to the sinks, then ``length``.

    Each write covers distinct indices, so no result rests on the order
    of duplicate-index writes.  Per-token group quantization makes a
    packed row independent of when it is quantized, hence the byte
    equality.  ``t0``/``n_valid`` are host ints (the caller's mirror of
    ``length``).

    CUDA tensors quantize with the bulk kernel; CPU tensors take
    :func:`kv_append_chunk_plain` unless ``quant_fn`` (the
    ``kv_cache.prefill`` quantizer contract) is given, which runs these
    steps with it on any device.  An fp16 policy raises
    NotImplementedError, and so does a pooled cache or a batch other than
    1 (ValueError), or ``t0 + n_valid`` past the cache's capacity."""
    if quant_fn is None:
        if k.device.type == "cpu":
            return kv_append_chunk_plain(cache, k, v, policy, t0, n_valid,
                                         alpha_k, alpha_v)
        if k.device.type != "cuda":
            raise ValueError(f"kv_append_chunk: unsupported device "
                             f"{k.device}")
        from .ops import make_kernel_quant_fn
        quant_fn = make_kernel_quant_fn()
    policy = as_layer_policy(policy)
    if policy.is_fp16:
        raise NotImplementedError(
            "kv_append_chunk: an fp16 policy has nothing to quantize; the "
            "card path has no fp16 mode (use kv_cache.prefill_chunk_append "
            "off the card)")
    if is_pooled(cache):
        raise ValueError("kv_append_chunk grows a striped cache; pooled "
                         "caches take their blocks from it at insert")
    if k.ndim != 4 or k.shape[0] != 1 or v.shape != k.shape:
        raise ValueError(f"kv_append_chunk wants k/v (1, C, H, D), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    t0, n_valid = int(t0), int(n_valid)
    w, ns = policy.window, policy.n_sink
    sq = cache["qk_codes_hi"].shape[1]
    end = t0 + n_valid
    if w == 0 and sq == 0:
        raise ValueError("kv_append_chunk: no window and no packed region")
    if t0 < 0 or not 0 <= n_valid <= k.shape[1] or end > ns + w + sq:
        raise ValueError(f"kv_append_chunk: tokens [{t0}, {end}) of a "
                         f"{k.shape[1]}-slot chunk do not fit a cache of "
                         f"{ns + w + sq} tokens")
    if n_valid == 0:
        return cache
    gsz = min(policy.group_size, k.shape[-1])
    lo, hi = chunk_evictions(policy, t0, n_valid)
    if w == 0 and end <= ns:
        # the token loop quantizes each sink token into packed row 0 (its
        # index clamps there) when there is no window; the last one stays
        lo, hi = end - 1, end
    if lo < hi:
        rows = []
        for name, x in (("k", k), ("v", v)):
            parts = []
            if lo < t0:                   # still in the ring: (p - ns) % w
                parts += _ring_rows(cache[f"win_{name}"], lo, min(hi, t0),
                                    ns, w)
            if hi > t0:
                part = x[:, max(lo, t0) - t0:hi - t0]
                parts.append(part.to(cache[f"win_{name}"].dtype) if w
                             else part)
            rows.append(parts[0] if len(parts) == 1 else
                        torch.cat(parts, dim=1))
        u0 = max(lo - ns, 0)
        for pref, bits, alpha, x in (("qk", policy.bits_k, alpha_k, rows[0]),
                                     ("qv", policy.bits_v, alpha_v, rows[1])):
            for kk, vv in quant_fn(x, bits, gsz, alpha,
                                   policy.fp8_meta).items():
                dst = cache[f"{pref}_{kk}"]
                dst[:, u0:u0 + vv.shape[1]] = vv.to(dst.dtype)
    if w > 0 and end > ns:
        a = max(ns, end - w, t0)          # the ring keeps [a, end)
        for name, x in (("k", k), ("v", v)):
            ring = cache[f"win_{name}"]
            for p0, p1 in _ring_runs(a, end, ns, w):
                s0 = (p0 - ns) % w
                ring[:, s0:s0 + p1 - p0] = x[:, p0 - t0:p1 - t0].to(
                    ring.dtype)
    if ns > 0 and t0 < ns:
        e = min(ns, end)
        for name, x in (("k", k), ("v", v)):
            sink = cache[f"sink_{name}"]
            sink[:, t0:e] = x[:, :e - t0].to(sink.dtype)
    cache["length"].fill_(end)
    return cache


def _ring_runs(p0: int, p1: int, ns: int, w: int):
    """Positions ``[p0, p1)`` (at most ``w`` of them) split where their
    ring slots ``(p - ns) % w`` wrap: one or two runs of contiguous
    slots."""
    cut = p0 + (w - (p0 - ns) % w)
    return [(p0, p1)] if cut >= p1 else [(p0, cut), (cut, p1)]


def _ring_rows(ring: torch.Tensor, p0: int, p1: int, ns: int, w: int):
    """The ring rows of positions ``[p0, p1)``, in position order."""
    out = []
    for a, b in _ring_runs(p0, p1, ns, w):
        s0 = (a - ns) % w
        out.append(ring[:, s0:s0 + b - a])
    return out
