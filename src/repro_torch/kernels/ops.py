"""Host side of the two kernels (port of ``repro.kernels.ops``; DESIGN.md
§4).

:func:`cuda_decode_attention` is the ``"cuda"`` decode backend: the packed
segment goes through the ``decode_attn`` kernel with per-slot block bounds
computed on the device, the small fp sink/window segment runs as torch
ops, and the partials merge by logsumexp.  :func:`make_kernel_quant_fn`
routes cache-side quantization through the ``kv_quant`` kernel.

Not ported yet: the fp16-policy fallback, the pooled (block-table) path
and the ``local_slice``/``packed_override`` levers with their pre-append
``extra_kv``/``q_pos`` protocol.
"""
from __future__ import annotations

import torch

from ..core.policy import QuantPolicy
from ..core.quant import n_meta_groups, packed_nbytes
from ..core import segments as seg
from ..core.kv_cache import slot_lengths
from .decode_attn import BLOCK_S, decode_attn
from .kv_quant import kv_quant

_FAR = 2 ** 30  # position of padded packed slots (always masked out)


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


def _padded_j(s_q: int, s_pad: int, device) -> torch.Tensor:
    j = torch.arange(s_pad, dtype=torch.int32, device=device)
    return torch.where(j < s_q, j, torch.full_like(j, _FAR))


def make_kernel_quant_fn():
    """A ``quant_fn`` for ``kv_cache.prefill``/``decode_append``: flattens
    the leading axes to kernel rows, tiles the per-head clip factors onto
    the rows, and calls the ``kv_quant`` kernel (plain version on CPU)."""
    def quant_fn(x, bits, group_size, alpha, fp8_meta):
        *lead, d = x.shape
        n = 1
        for s in lead:
            n *= s
        a_rows = None
        if alpha is not None:
            g_total = n_meta_groups(d, bits, min(group_size, d))
            alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                    device=x.device)
            a_rows = alpha.expand(*lead, g_total).reshape(n, g_total)
        qt = kv_quant(x.reshape(n, d), bits, min(group_size, d),
                      alpha=a_rows, fp8_meta=fp8_meta)
        return {k: v.reshape(*lead, v.shape[-1]) for k, v in qt.items()}
    return quant_fn


def cuda_decode_attention(q, cache, policy: QuantPolicy, *, scale: float,
                          softcap: float = 0.0, window=None,
                          dtype=torch.bfloat16, block_s: int = BLOCK_S,
                          prune_blocks: bool = True):
    """Fused-kernel decode over the SKVQ cache (DESIGN.md §4).

    q (B, 1, Hq, D) -> (B, 1, Hq, D); the query token is already appended.
    ``cache["length"]`` is per-slot, so the kernel takes a per-(slot,
    token) mask.  With ``prune_blocks`` the mask reduces on the device to
    per-slot block bounds ``[lo, hi)`` and the kernel skips dead tiles,
    bit-identically to the full walk."""
    if policy.is_fp16:
        raise NotImplementedError("the fp16-policy fallback of the decode "
                                  "wrapper is not ported yet")
    from ..models.attention import fp_segment_partial
    b, _, hq, d = q.shape
    lens = slot_lengths(cache, b)
    t_now = lens - 1
    weff = seg.effective_window(window)
    hkv = (cache["win_k"] if "win_k" in cache else cache["qk_codes_hi"]
           ).shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    parts = []
    s_q = cache["qk_codes_hi"].shape[1] if "qk_codes_hi" in cache else 0
    if s_q > 0:
        k_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")}
        v_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")}
        bs, s_pad = _block_pad(s_q, block_s)
        ok = _packed_ok(_padded_j(s_q, s_pad, q.device), lens, t_now, weff,
                        policy, b)
        bounds = seg.packed_block_bounds(ok, bs) if prune_blocks else None
        num, m, l = decode_attn(qg, k_qt, v_qt, ok.to(torch.float32), policy,
                                d, scale, block_s=bs, softcap=softcap,
                                block_bounds=bounds)
        parts.append((num, m[..., 0], l[..., 0]))
    parts.extend(fp_segment_partial(qg, cache, policy, lens, t_now, weff,
                                    scale, softcap, dtype))
    return seg.finalize(parts).reshape(b, 1, hq, d).to(q.dtype)


def decode_block_report(cache, policy: QuantPolicy, head_dim: int, *,
                        window=None, block_s: int = BLOCK_S):
    """Pruning accounting for the packed walk (DESIGN.md §4): ``bounds``
    (B, 2), ``visited`` (B,) blocks, ``total`` capacity blocks and
    ``bytes_per_block`` packed-plane bytes one block moves (all kv heads)."""
    s_q = cache["qk_codes_hi"].shape[1] if "qk_codes_hi" in cache else 0
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
