"""Attention for the port's dense decoder (port of the prefill and
reference-decode paths of ``repro.models.attention``).

* :func:`prefill_block_attention` — full-precision causal prefill with the
  reference's FIXED 128-wide key-block online-softmax loop (DESIGN.md §7:
  chunked prefill depends on this reduction structure).
* :func:`decode_attention_skvq` — the ``"reference"`` backend: dequantize
  the packed region in the compute dtype and attend with the shared flash
  partials (DESIGN.md §4).  Its ``chunk``/``local_slice``/
  ``packed_override`` levers are not ported yet.
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

_NEG = -1e30
PREFILL_BLOCK = 128  # key-block width of the prefill reduction


def _scale(cfg: ArchConfig) -> float:
    return cfg.query_scale if cfg.query_scale > 0 else cfg.head_dim ** -0.5


def _band_mask(pos_q, pos_k, window_eff: int):
    """(Sq, Sk) causal ∧ local-band mask; window 0 = full."""
    d = pos_q[:, None] - pos_k[None, :]
    w = window_eff if window_eff > 0 else 2 ** 30
    return (d >= 0) & (d < w)


def prefill_block_attention(q, k, v, cfg: ArchConfig, *, pos_q=None,
                            window: Optional[int] = None,
                            block: int = PREFILL_BLOCK):
    """Causal prefill attention over ``block``-wide key tiles with
    online-softmax merging (DESIGN.md §7).  q (B, Sq, Hq, D); k/v
    (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype."""
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


def decode_attention_skvq(q, cache, cfg: ArchConfig, policy: QuantPolicy,
                          window: Optional[int] = None,
                          dtype=torch.bfloat16):
    """Reference decode over the SKVQ cache: dequantize -> attend
    (DESIGN.md §4).  Per-slot aware: ``cache["length"]`` is (B,); the query
    token is already appended.  q (B, 1, Hq, D) -> (B, 1, Hq, D)."""
    w, ns = policy.window, policy.n_sink
    b, _, hq, d = q.shape
    lens = kvc.slot_lengths(cache, b)
    t_now = lens - 1
    scale = _scale(cfg)
    weff = seg.effective_window(window)

    if policy.is_fp16:  # uncompressed-cache baseline
        hkv = cache["k"].shape[2]
        qg = q.reshape(b, hkv, hq // hkv, d)
        pos = torch.arange(cache["k"].shape[1], device=q.device)
        ok = seg.attend_ok(pos, pos[None, :] < lens[:, None], t_now, weff)
        num, m, l = seg.partial_attend(qg, cache["k"].to(dtype),
                                       cache["v"].to(dtype), ok, scale,
                                       cfg.attn_softcap)
        out = num / l.clamp_min(1e-30)[..., None]
        return out.reshape(b, 1, hq, d).to(q.dtype)

    hkv = (cache["win_k"] if "win_k" in cache else cache["qk_codes_hi"]
           ).shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    parts = []
    s_q = cache["qk_codes_hi"].shape[1] if "qk_codes_hi" in cache else 0
    if s_q > 0:
        gsz = min(policy.group_size, d)
        k_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")}
        v_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")}
        j = torch.arange(s_q, device=q.device)
        pos_q, stored_q = seg.packed_segment(j, lens, ns, w)
        ok_q = seg.attend_ok(pos_q, stored_q, t_now, weff)
        keys = dequantize_groups(k_qt, d, policy.bits_k, gsz, policy.fp8_meta,
                                 dtype)
        values = dequantize_groups(v_qt, d, policy.bits_v, gsz,
                                   policy.fp8_meta, dtype)
        parts.append(seg.partial_attend(qg, keys, values, ok_q, scale,
                                        cfg.attn_softcap))
    parts.extend(fp_segment_partial(qg, cache, policy, lens, t_now, weff,
                                    scale, cfg.attn_softcap, dtype))
    return seg.finalize(parts).reshape(b, 1, hq, d).to(q.dtype)


def fp_segment_partial(qg, cache, policy: QuantPolicy, lens, t_now, weff,
                       scale: float, cap: float, dtype):
    """The fp sink + window-ring partial shared by both decode backends
    (DESIGN.md §1, §4): ``[]`` when the policy keeps no fp segment."""
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
    if not ks:
        return []
    kf = torch.cat(ks, dim=1).to(dtype)
    vf = torch.cat(vs, dim=1).to(dtype)
    ok = seg.attend_ok(torch.cat(pos, dim=1), torch.cat(valid, dim=1), t_now,
                       weff)
    return [seg.partial_attend(qg, kf, vf, ok, scale, cap)]
