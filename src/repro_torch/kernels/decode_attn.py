"""Fused dequantize + online-softmax decode attention over the packed SKVQ
planes (port of the TPU kernel ``decode_attn_pallas``,
``src/repro/kernels/decode_attn.py``: the striped layout with block bounds,
and the block-table (pooled) mode of DESIGN.md §9).

:func:`decode_attn` launches ``csrc/decode_attn.cu`` on CUDA tensors and
takes the plain PyTorch version :func:`decode_attn_plain` only for CPU
tensors.  Both walk ``block_s``-token tiles with an f32 online softmax and
return the UNNORMALIZED triple ``(num (B,Hkv,Gq,D), m (B,Hkv,Gq,1),
l (B,Hkv,Gq,1))``; a tile outside a slot's ``[lo, hi)`` bounds is skipped,
bit-identically to the full walk (DESIGN.md §4).  The bounds stay on the
device: neither version reads them back to the host.

Planes ``(B, S, Hkv, ...)`` may hold fewer tokens than the mask
``(B, S_mask)``, ``S_mask`` a multiple of ``block_s``: the kernel treats
tokens at or past ``S`` as masked and never reads them; the plain version
pads the planes (scale = 1.0, :func:`pad_planes`) to the same effect.

What bounds it on an H100 and the design: see the note at the top of
``csrc/decode_attn.cu``.  In short, it is bytes-bound (62 B per live
token-head at D = 128, K2/V1.5, for ~4 * D * Gq f32 flops, far below the
295 flop/byte ridge, so no ``wgmma``); the kernel splits each slot's
sequence across CTAs by :func:`split_plan` (shapes only: never the bounds,
so no host sync and the launch stays capturable), each CTA covering up to
8 kv heads with coalesced ``cp.async`` row copies through a 3-stage
shared-memory ring; a second kernel merges the split partials by
logsumexp in split order, with no atomics, so launches are bitwise
repeatable and the pruned walk equals the full walk bitwise.

Pooled mode (``block_table`` (B, NB) int32): the planes are pool-major
``(NP, BT, Hkv, ...)`` and logical token ``t`` of slot ``b`` reads physical
block ``block_table[b, t // BT]`` at offset ``t % BT``; the logical length
is ``NB * BT``, and the mask and bounds stay in logical coordinates.  The
kernel gathers per token, so ``block_s`` need not equal ``BT``.  The plain
version gathers the planes into the striped view first
(:func:`gather_planes`), then walks them as in striped mode.

``LAUNCHES["kernel"]`` counts striped kernel launches,
``LAUNCHES["pooled"]`` block-table kernel launches and ``LAUNCHES["plain"]``
calls of the plain version (either mode).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ..core.kv_cache import gather_blocks
from ..launch import op_cost
from ..core.packing import unpack_u8
from ..core.policy import QuantPolicy
from ..core.quant import packed_nbytes, plane_layout

BLOCK_S = 256
NEG = -1e30
CHUNK = 32           # tokens per chunk of the kernel (kTT in the source)
STAGES = 3           # depth of its shared-memory ring (kStages)
CTAS_PER_SM = 8      # split plan target
MAX_HEADS = 8        # kv heads per CTA (kMaxHG)
STAGE_BUDGET = 96 * 1024   # shared-memory bytes of the ring the plan aims at
# bit pattern of float8_e4m3fn(1.0): sign 0, exponent 0111 (bias 7)
FP8_ONE = 0x38
LAUNCHES = {"kernel": 0, "pooled": 0, "plain": 0}
_C = ctypes
_SM_COUNT: Dict[int, int] = {}


def split_plan(n_blocks: int, block_s: int, b: int, hkv: int,
               token_head_bytes: int, sm_count: int) -> Tuple[int, int, int]:
    """The kernel's launch plan, from shapes alone: ``(hg, tiles_per_split,
    n_splits)``.

    ``hg`` kv heads share a CTA (the largest of 8, 4, 2, 1 that divides
    ``hkv`` and keeps the copy ring of ``token_head_bytes`` per token-head
    within :data:`STAGE_BUDGET`).  The ``n_blocks`` tiles of ``block_s``
    tokens are cut into ``n_splits`` runs of ``tiles_per_split`` (the last
    may be shorter) so that the grid has about :data:`CTAS_PER_SM` CTAs per
    SM, each run covering at least one chunk.  Split ``s`` owns tiles
    ``[s * tiles_per_split, min((s + 1) * tiles_per_split, n_blocks))``.
    The bounds play no part: pruning clips a CTA's range on the device."""
    hg = MAX_HEADS
    while hg > 1 and (hkv % hg or
                      hg * token_head_bytes * CHUNK * STAGES > STAGE_BUDGET):
        hg //= 2
    want = max(1, -(-CTAS_PER_SM * sm_count // (b * (hkv // hg))))
    tps = max(-(-CHUNK // block_s), -(-n_blocks // want))
    n_splits = -(-n_blocks // tps)
    return hg, -(-n_blocks // n_splits), n_splits


def launch_plan(b: int, hkv: int, head_dim: int, policy: QuantPolicy,
                s_mask: int, block_s: int, device: torch.device
                ) -> Tuple[int, int, int]:
    """:func:`split_plan` of a launch on ``device``."""
    gsz = min(policy.group_size, head_dim)
    nbytes = sum(packed_nbytes(head_dim, bits, gsz, policy.meta_dtype_bits)
                 for bits in (policy.bits_k, policy.bits_v))
    return split_plan(s_mask // block_s, block_s, b, hkv, nbytes,
                      _sm_count(device))


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def pad_planes(qt: Dict[str, torch.Tensor], s_pad: int, fp8_meta: bool
               ) -> Dict[str, torch.Tensor]:
    """Pad packed planes along the token axis to ``s_pad`` tokens; scale
    planes take the encoding of 1.0 (not 0), so dequantized padding is
    ordinary finite data whatever the mask says."""
    out = {}
    for k, v in qt.items():
        pad = s_pad - v.shape[1]
        if pad <= 0:
            out[k] = v
            continue
        fill = (FP8_ONE if fp8_meta else 1.0) if k.startswith("scale") else 0
        tail = torch.full((v.shape[0], pad) + tuple(v.shape[2:]), fill,
                          dtype=v.dtype, device=v.device)
        out[k] = torch.cat([v, tail], dim=1)
    return out


def gather_planes(qt: Dict[str, torch.Tensor], block_table: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Pool-major planes (NP, BT, Hkv, W) -> the striped view
    (B, NB*BT, Hkv, W) of the slots in ``block_table`` (B, NB)."""
    return {k: gather_blocks(v, block_table) for k, v in qt.items()}


def _dequant_tile(qt, sl: slice, layout, fp8_meta: bool) -> torch.Tensor:
    """One (B, T, Hkv, D) tile of the planes, dequantized in f32."""
    parts = []
    for name, (_, width, bits, gs) in zip(("hi", "lo"), layout):
        codes = unpack_u8(qt[f"codes_{name}"][:, sl], bits).to(torch.float32)
        sc, zr = qt[f"scale_{name}"][:, sl], qt[f"zero_{name}"][:, sl]
        if fp8_meta:
            h = sc.view(torch.float8_e4m3fn).to(torch.float32)
            lo = zr.view(torch.float8_e4m3fn).to(torch.float32)
        else:
            h, lo = sc.to(torch.float32), zr.to(torch.float32)
        *lead, _ = codes.shape
        xg = codes.reshape(*lead, width // gs, gs) * h[..., None] + lo[..., None]
        parts.append(xg.reshape(*lead, width))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def decode_attn_plain(q, k_qt, v_qt, mask, policy: QuantPolicy,
                      head_dim: int, scale: float, block_s: int = BLOCK_S,
                      softcap: float = 0.0,
                      block_bounds: Optional[torch.Tensor] = None,
                      block_table: Optional[torch.Tensor] = None):
    """Plain PyTorch version, tile by tile as the TPU kernel walks them;
    pooled planes are gathered into the striped view first."""
    LAUNCHES["plain"] += 1
    if block_table is not None:
        k_qt = gather_planes(k_qt, block_table)
        v_qt = gather_planes(v_qt, block_table)
    b, hkv, gq, d = q.shape
    s_mask = mask.shape[-1]
    gsz = min(policy.group_size, head_dim)
    layout_k = plane_layout(head_dim, policy.bits_k, gsz)
    layout_v = plane_layout(head_dim, policy.bits_v, gsz)
    k_qt = pad_planes(k_qt, s_mask, policy.fp8_meta)
    v_qt = pad_planes(v_qt, s_mask, policy.fp8_meta)
    mask = mask.to(torch.float32)
    qs = q.to(torch.float32) * scale
    acc = torch.zeros((b, hkv, gq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, gq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, gq), dtype=torch.float32, device=q.device)
    for blk in range(s_mask // block_s):
        sl = slice(blk * block_s, (blk + 1) * block_s)
        kt = _dequant_tile(k_qt, sl, layout_k, policy.fp8_meta)
        vt = _dequant_tile(v_qt, sl, layout_v, policy.fp8_meta)
        mk = mask[:, sl][:, None, None, :]
        s = torch.einsum("bhgd,bthd->bhgt", qs, kt)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mk > 0, s, torch.full_like(s, NEG))
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None]) * mk
        alpha = torch.exp(m - m_cur)
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bhgt,bthd->bhgd",
                                                        p, vt)
        if block_bounds is None:
            acc, m, l = acc_new, m_cur, l_new
            continue
        live = ((block_bounds[:, 0] <= blk) & (blk < block_bounds[:, 1]))
        live = live[:, None, None]
        acc = torch.where(live[..., None], acc_new, acc)
        m = torch.where(live, m_cur, m)
        l = torch.where(live, l_new, l)
    return acc, m[..., None], l[..., None]


def _lib():
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    if fn.argtypes is None:
        plane = [_C.c_void_p] * 3 + [_C.c_int] * 4
        side = [_C.c_int] + plane + plane
        fn.argtypes = ([_C.c_void_p] * 4 + [_C.c_int] * 3 + side + side
                       + [_C.c_int] * 7 + [_C.c_float, _C.c_float, _C.c_int]
                       + [_C.c_int] * 2 + [_C.c_void_p] * 5)
        fn.restype = _C.c_int
    return fn


def _plane_args(qt, layout):
    args = []
    for name, (start, width, bits, gs) in zip(("hi", "lo"), layout):
        args += [qt[f"codes_{name}"].data_ptr(),
                 qt[f"scale_{name}"].data_ptr(),
                 qt[f"zero_{name}"].data_ptr(), start, width, bits, gs]
    if len(layout) == 1:
        args += [None, None, None, 0, 0, 8, 1]
    return [len(layout)] + args


def live_tokens(mask: torch.Tensor) -> int:
    """Tokens a mask (B, S_mask) lets a slot attend, summed over the
    slots (read back to the host); every entry for a tensor without
    values (fake or meta)."""
    try:
        return int((mask > 0).sum())
    except Exception:            # a fake or meta tensor has no values
        return mask.numel()


def attn_cost(q, mask, policy: QuantPolicy, head_dim: int
              ) -> Tuple[float, float]:
    """(f32 operations, bytes) of one launch, from its arguments: each
    live token's packed K and V rows of every kv head read once, its mask
    entry, q, and the outputs ``(num, m, l)`` written once; per live token
    and kv head, dequantizing K and V (2 x 2D) and q.k and p.v for each
    of the Gq query rows (2 x 2D x Gq) -- PERF.md §6's bound of the
    kernel."""
    b, hkv, gq, d = q.shape
    gsz = min(policy.group_size, head_dim)
    bits = policy.meta_dtype_bits
    per_tok = hkv * (packed_nbytes(d, policy.bits_k, gsz, bits)
                     + packed_nbytes(d, policy.bits_v, gsz, bits))
    n_live = live_tokens(mask)
    nbytes = (n_live * (per_tok + 4) + q.numel() * 4
              + 4 * b * hkv * gq * (d + 2))
    return n_live * hkv * (4 * d + 4 * d * gq), nbytes


def decode_attn(q, k_qt, v_qt, mask, policy: QuantPolicy, head_dim: int,
                scale: float, block_s: int = BLOCK_S, softcap: float = 0.0,
                block_bounds: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See :func:`_decode_attn`; reports :func:`attn_cost` to an active
    ``launch.op_cost`` counter."""
    with op_cost.kernel_cost("decode_attn", lambda: attn_cost(
            q, mask, policy, head_dim)):
        return _decode_attn(q, k_qt, v_qt, mask, policy, head_dim, scale,
                            block_s, softcap, block_bounds, block_table)


def _decode_attn(q, k_qt, v_qt, mask, policy: QuantPolicy, head_dim: int,
                 scale: float, block_s: int = BLOCK_S, softcap: float = 0.0,
                 block_bounds: Optional[torch.Tensor] = None,
                 block_table: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Hkv, Gq, D); planes (B, S, Hkv, ...), or pool-major
    (NP, BT, Hkv, ...) with ``block_table`` (B, NB) int32 and S = NB * BT;
    mask (B, S_mask) float, ``S <= S_mask``, ``S_mask % block_s == 0``;
    block_bounds (B, 2) int32 ``[lo, hi)`` on the device, or None for the
    full walk.

    CUDA tensors launch the kernel (and raise if it fails); CPU tensors take
    :func:`decode_attn_plain`."""
    if q.device.type == "cpu":
        return decode_attn_plain(q, k_qt, v_qt, mask, policy, head_dim,
                                 scale, block_s, softcap, block_bounds,
                                 block_table)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    b, hkv, gq, d = q.shape
    pooled = block_table is not None
    if pooled:
        if (block_table.ndim != 2 or block_table.shape[0] != b
                or block_table.device != q.device):
            raise ValueError(f"decode_attn: block_table must be (B, NB) on "
                             f"{q.device}, got {tuple(block_table.shape)}")
        tbl = block_table.to(torch.int32).contiguous()
        n_phys, bt = k_qt["codes_hi"].shape[:2]
        nb = tbl.shape[1]
        s, rows = nb * bt, (n_phys, bt)
    else:
        s = k_qt["codes_hi"].shape[1]
        rows = (b, s)
    s_mask = mask.shape[-1]
    if d != head_dim or s_mask % block_s or s > s_mask or block_s > 256 \
            or gq > 8 or gq * d > 1024 or d % 4:
        raise ValueError(
            f"decode_attn: unsupported shape q={tuple(q.shape)} S={s} "
            f"S_mask={s_mask} block_s={block_s}")
    gsz = min(policy.group_size, head_dim)
    layout_k = plane_layout(head_dim, policy.bits_k, gsz)
    layout_v = plane_layout(head_dim, policy.bits_v, gsz)
    meta_dt = torch.uint8 if policy.fp8_meta else torch.float16
    for _, width, bits, gs in layout_k + layout_v:
        if gs % 4 or gs * bits % 8:
            raise ValueError(f"decode_attn: quant groups of {gs} channels at "
                             f"{bits} bits are not whole bytes of 4-channel "
                             f"quads")
    for qt, layout in ((k_qt, layout_k), (v_qt, layout_v)):
        for name, (_, width, bits, gs) in zip(("hi", "lo"), layout):
            for part, w, dt in (("codes", width * bits // 8, torch.uint8),
                                ("scale", width // gs, meta_dt),
                                ("zero", width // gs, meta_dt)):
                v = qt[f"{part}_{name}"]
                if (tuple(v.shape) != rows + (hkv, w) or v.dtype != dt
                        or not v.is_contiguous() or v.device != q.device):
                    raise ValueError(
                        f"decode_attn: plane {part}_{name} must be a "
                        f"contiguous {dt} tensor of shape {rows + (hkv, w)} "
                        f"on {q.device}, got {v.dtype} {tuple(v.shape)}")
    if tuple(mask.shape) != (b, s_mask):
        raise ValueError(f"decode_attn: mask must be (B, S_mask), got "
                         f"{tuple(mask.shape)}")
    n_blocks = s_mask // block_s
    if block_bounds is None:
        block_bounds = torch.zeros((b, 2), dtype=torch.int32, device=q.device)
        block_bounds[:, 1] = n_blocks
    if tuple(block_bounds.shape) != (b, 2) or block_bounds.device != q.device:
        raise ValueError(f"decode_attn: block_bounds must be (B, 2) on "
                         f"{q.device}, got {tuple(block_bounds.shape)}")
    bounds = block_bounds.to(torch.int32).contiguous()
    q32 = q.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    num = torch.empty((b, hkv, gq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, gq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, gq, 1), dtype=torch.float32, device=q.device)
    hg, _, n_splits = launch_plan(b, hkv, d, policy, s_mask, block_s,
                                  q.device)
    part = (torch.empty((b * hkv * n_splits * gq * (d + 2),),
                        dtype=torch.float32, device=q.device)
            if n_splits > 1 else None)
    table_args = ([tbl.data_ptr(), nb, bt, n_phys] if pooled
                  else [None, 0, 0, 0])
    rc = _lib()(q32.data_ptr(), mask.data_ptr(), bounds.data_ptr(),
                *table_args,
                *_plane_args(k_qt, layout_k), *_plane_args(v_qt, layout_v),
                b, s, s_mask, hkv, gq, d, block_s, float(scale),
                float(softcap), int(policy.fp8_meta), hg, n_splits,
                None if part is None else part.data_ptr(), num.data_ptr(),
                m.data_ptr(), l.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn")
    LAUNCHES["pooled" if pooled else "kernel"] += 1
    return num, m, l
