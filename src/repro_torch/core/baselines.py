"""The KV-cache quantization methods the paper compares (Table 1), on the
fake-quant quality path (port of ``repro.core.baselines``; DESIGN.md §2).

* RTN: asymmetric per-token round-to-nearest (group = head_dim);
* RTN-sym: the symmetric variant (Table 2);
* SmoothQuant: per-channel equalization s = max|K_ch| (alpha = 1, wholly
  on the KV cache), then per-token RTN;
* RPTQ: channel reorder only (no clip, no window);
* KIVI: per-CHANNEL key quantization (groups along the token axis) and
  per-token values, with the most recent tokens in full precision;
* SKVQ: reorder + clip + window + sinks, with fp8 metadata.

Each method is ``(k, v, ctx) -> (k_hat, v_hat)`` with k/v (B, S, H, D) and
``ctx`` carrying the calibration; the window is applied by position (the
last ``window`` tokens pass through).  The quantizer is ``ctx.quant_fn``
when set, else chosen by the tensors' device, as calibration chooses it
(``calibrate.resolve_quant_fn``): the bulk ``kv_quant`` kernel on CUDA
tensors, the plain ``quantize_groups`` on CPU ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .calibrate import LayerCalibration, resolve_quant_fn
from .policy import QuantPolicy
from .quant import fake_quant
from .reorder import invert_permutation, on_device


@dataclasses.dataclass
class MethodCtx:
    """What a method needs besides K/V: the policy, the layer's
    calibration (perms, clip factors, smoothing factors) and the quantizer
    (``None``: :func:`~.calibrate.resolve_quant_fn`'s choice for the
    tensors' device)."""
    policy: QuantPolicy
    calib: Optional[LayerCalibration] = None
    quant_fn: Optional[Callable] = None


def _fq(x, bits, ctx: MethodCtx, alpha=None, axis: int = -1):
    p = ctx.policy
    return fake_quant(x, bits, p.group_size, alpha=alpha, fp8_meta=p.fp8_meta,
                      axis=axis, quant_fn=resolve_quant_fn(ctx.quant_fn,
                                                           x.device))


def _window_mix(x, xq, window: int, n_sink: int = 0):
    """Keep the last ``window`` and the first ``n_sink`` tokens in full
    precision."""
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)
    keep = pos >= s - window
    if n_sink > 0:
        keep = keep | (pos < n_sink)
    return torch.where(keep[None, :, None, None], x, xq)


def _apply_perm(x, perm):
    idx = on_device(perm, x.device).long()
    return torch.gather(x, -1, idx[None, None].expand(x.shape))


def rtn(k, v, ctx: MethodCtx):
    p = ctx.policy
    return _fq(k, p.bits_k, ctx), _fq(v, p.bits_v, ctx)


def rtn_sym(k, v, ctx: MethodCtx):
    """Symmetric per-token RTN (zero-point fixed at 0): the Table 2
    reference."""
    p = ctx.policy

    def symq(x, bits):
        gs = min(p.group_size, x.shape[-1])
        *lead, d = x.shape
        xg = x.reshape(*lead, d // gs, gs).to(torch.float32)
        m = xg.abs().amax(dim=-1, keepdim=True)
        n_levels = 2 ** (int(bits) - 1) - 1
        h = (m / torch.full_like(m, n_levels)).clamp_min(1e-8)
        q = torch.round(xg / h).clamp(-n_levels - 1, n_levels)
        return (q * h).reshape(*lead, d).to(x.dtype)

    return symq(k, p.bits_k), symq(v, p.bits_v)


def smoothquant(k, v, ctx: MethodCtx):
    p = ctx.policy
    s = on_device(ctx.calib.smooth_k, k.device)[None, None]
    return _fq(k / s, p.bits_k, ctx) * s, _fq(v, p.bits_v, ctx)


def rptq(k, v, ctx: MethodCtx):
    """Reorder only (per-head permutation): no clip, no window."""
    p, c = ctx.policy, ctx.calib
    kq = _fq(_apply_perm(k, c.perm_k), p.bits_k, ctx)
    vq = _fq(_apply_perm(v, c.perm_v), p.bits_v, ctx)
    return (_apply_perm(kq, invert_permutation(c.perm_k)),
            _apply_perm(vq, invert_permutation(c.perm_v)))


def kivi(k, v, ctx: MethodCtx):
    """KIVI-style: K per channel (groups along the tokens), V per token,
    an fp residual window."""
    p = ctx.policy
    kq = _fq(k, p.bits_k, ctx, axis=1)
    vq = _fq(v, p.bits_v, ctx)
    return _window_mix(k, kq, p.window), _window_mix(v, vq, p.window)


def skvq(k, v, ctx: MethodCtx):
    """Full SKVQ on the fake-quant path (reorder + clip + window + sinks)."""
    p, c = ctx.policy, ctx.calib
    ak = on_device(c.alpha_k, k.device) if p.clip else None
    av = on_device(c.alpha_v, v.device) if p.clip else None
    kq = _fq(_apply_perm(k, c.perm_k), p.bits_k, ctx, alpha=ak)
    vq = _fq(_apply_perm(v, c.perm_v), p.bits_v, ctx, alpha=av)
    kq = _apply_perm(kq, invert_permutation(c.perm_k))
    vq = _apply_perm(vq, invert_permutation(c.perm_v))
    return (_window_mix(k, kq, p.window, p.n_sink),
            _window_mix(v, vq, p.window, p.n_sink))


METHODS = {"fp16": lambda k, v, ctx: (k, v), "rtn": rtn, "rtn_sym": rtn_sym,
           "smoothquant": smoothquant, "rptq": rptq, "kivi": kivi, "skvq": skvq}
