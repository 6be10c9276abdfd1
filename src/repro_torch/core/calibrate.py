"""Offline calibration (port of ``repro.core.calibrate``; paper Sec. 3.1
and the prologue of Alg. 1; DESIGN.md §2-§3).

Two artifacts a layer, computed once on a calibration set and then frozen:

* per-head channel permutations for K and V (:mod:`.reorder`, the
  reference's numpy code: equal permutations on equal samples);
* per-group clip factors alpha (Eq. 3), by a grid search over
  :data:`ALPHA_GRID` of the per-group reconstruction MSE, with an optional
  attention-output refinement of a per-layer multiplier
  (:func:`refine_attention_mse`).

The search quantizes every sample at each grid point through a
``quant_fn``: on CUDA samples ``None`` means the bulk ``kv_quant`` kernel
(one launch per grid point for K and for V of a layer), on CPU samples
the plain :func:`~repro_torch.core.quant.quantize_groups`.  Samples may
be tensors on either device, or numpy arrays (the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import reorder as reorder_lib
from .policy import QuantPolicy
from .quant import fake_quant, n_meta_groups, plane_layout, quantize_groups

ALPHA_GRID = tuple(np.round(np.linspace(0.5, 1.0, 11), 3))
_STACKED = ("perm_k", "perm_v", "alpha_k", "alpha_v")


@dataclasses.dataclass
class LayerCalibration:
    """Calibration artifacts of one attention layer (numpy, as in the
    reference)."""
    perm_k: np.ndarray          # (H_kv, head_dim) int32
    perm_v: np.ndarray          # (H_kv, head_dim)
    alpha_k: np.ndarray         # (H_kv, G_total) float32
    alpha_v: np.ndarray         # (H_kv, G_total)
    smooth_k: Optional[np.ndarray] = None   # (H_kv, head_dim), baselines only


@dataclasses.dataclass
class Calibration:
    """Every layer's :class:`LayerCalibration`, in layer order."""
    layers: list

    def stacked(self, device=None) -> dict:
        """The ``(L, ...)`` table the passes take, with the keys, shapes and
        dtypes of ``transformer.identity_calib``: perms int64, clip
        factors f32, on ``device`` (default CUDA)."""
        dev = resolve_device(device)
        out = {}
        for f in _STACKED:
            t = torch.from_numpy(np.stack([getattr(l, f) for l in self.layers]))
            out[f] = (t.long() if f.startswith("perm")
                      else t.to(torch.float32)).to(dev)
        return out


def resolve_quant_fn(quant_fn: Optional[Callable], device) -> Callable:
    """The quantizer of the quality path on ``device``: ``quant_fn`` when
    given; else the bulk ``kv_quant`` kernel on CUDA and the plain
    ``quantize_groups`` on the CPU (no fallback between them)."""
    if quant_fn is not None:
        return quant_fn
    if torch.device(device).type == "cuda":
        from ..kernels.ops import make_kernel_quant_fn
        return make_kernel_quant_fn()
    return quantize_groups


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _host(x) -> np.ndarray:
    """Samples as a host numpy array in their own precision (bf16 widened
    exactly to f32), for the reference's numpy statistics."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _group_mse_alpha(x: torch.Tensor, bits: float, group_size: int,
                     fp8_meta: bool, quant_fn: Optional[Callable] = None
                     ) -> np.ndarray:
    """Per-group best clip alpha by reconstruction MSE grid search.

    x: (N, H, D) samples, already reordered.  Returns alpha (H, G_total)
    f32, G_total following ``plane_layout`` (mixed widths have per-plane
    group sizes); ties keep the first grid point, as ``jnp.argmin``."""
    x = _tensor(x).to(torch.float32)
    qf = resolve_quant_fn(quant_fn, x.device)
    n, h, d = x.shape
    layout = plane_layout(d, bits, group_size)
    errs = []
    for a in ALPHA_GRID:
        alpha = torch.tensor(np.float32(a), device=x.device)
        xq = fake_quant(x, bits, group_size, alpha=alpha, fp8_meta=fp8_meta,
                        quant_fn=qf)
        parts = []
        for (start, width, _b, gs) in layout:
            e = (xq[..., start:start + width] - x[..., start:start + width]) ** 2
            parts.append(e.reshape(n, h, width // gs, gs).mean(dim=(0, 3)))
        errs.append(torch.cat(parts, dim=-1))             # (H, G_total)
    best = torch.stack(errs).argmin(dim=0)                # (H, G_total)
    grid = torch.tensor(ALPHA_GRID, dtype=torch.float32, device=x.device)
    return grid[best].cpu().numpy()


def _reordered(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    idx = torch.from_numpy(perm).to(x.device).long()
    return torch.gather(x, 2, idx[None].expand(x.shape))


def calibrate_layer(k_samples, v_samples, policy: QuantPolicy, seed: int = 0,
                    quant_fn: Optional[Callable] = None) -> LayerCalibration:
    """k/v_samples: (N, H_kv, head_dim) activations of the calibration set.
    Permutations (K seeded ``seed``, V ``seed + 977``, head i ``+ i``) and
    smoothing factors on the host; the clip search on the samples' device
    through ``quant_fn`` (:func:`resolve_quant_fn`)."""
    k, v = _tensor(k_samples), _tensor(v_samples)
    h, d = k.shape[1], k.shape[2]
    gs = min(policy.group_size, d)
    k_host = _host(k)
    if policy.reorder:
        perm_k = reorder_lib.compute_permutations(k_host, gs, seed=seed)
        perm_v = reorder_lib.compute_permutations(_host(v), gs,
                                                  seed=seed + 977)
    else:
        perm_k = perm_v = np.tile(np.arange(d, dtype=np.int32), (h, 1))
    if policy.clip:
        alpha_k = _group_mse_alpha(_reordered(k, perm_k), policy.bits_k, gs,
                                   policy.fp8_meta, quant_fn)
        alpha_v = _group_mse_alpha(_reordered(v, perm_v), policy.bits_v, gs,
                                   policy.fp8_meta, quant_fn)
    else:
        alpha_k = np.ones((h, n_meta_groups(d, policy.bits_k, gs)), np.float32)
        alpha_v = np.ones((h, n_meta_groups(d, policy.bits_v, gs)), np.float32)
    smooth_k = reorder_lib.smooth_factors(k_host)   # cheap; baselines use it
    return LayerCalibration(perm_k, perm_v, alpha_k, alpha_v, smooth_k)


def calibrate_model(kv_collector: Callable[[], tuple], policy: QuantPolicy,
                    seed: int = 0, quant_fn: Optional[Callable] = None
                    ) -> Calibration:
    """``kv_collector() -> (K, V)``, each stacked ``(L, N, H_kv, head_dim)``
    (``transformer.collect_kv``); layer ``l`` is calibrated with seed
    ``seed + 31 * l``."""
    ks, vs = kv_collector()
    return Calibration([calibrate_layer(ks[l], vs[l], policy,
                                        seed=seed + 31 * l, quant_fn=quant_fn)
                        for l in range(ks.shape[0])])


def refine_attention_mse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         calib: LayerCalibration, policy: QuantPolicy,
                         grid=(0.85, 0.9, 0.95, 1.0),
                         quant_fn: Optional[Callable] = None) -> float:
    """Eq. 3: the global per-layer multiplier on alpha that minimizes the
    MSE of the attention output (softmax(QK^T)V) before and after KV
    quantization.  q/k/v: (B, S, H, D), K/V already reordered; the first
    best multiplier of ``grid`` wins."""
    qf = resolve_quant_fn(quant_fn, q.device)
    scale = torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype,
                         device=q.device)

    def attn(kq, vq):
        s = torch.einsum("bshd,bthd->bhst", q, kq) / scale
        mask = torch.ones((q.shape[1], kq.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), vq)

    ref = attn(k, v)
    best, best_err = 1.0, np.inf
    for m in grid:
        ak = torch.as_tensor(calib.alpha_k * m, device=q.device)
        av = torch.as_tensor(calib.alpha_v * m, device=q.device)
        kq = fake_quant(k, policy.bits_k, policy.group_size, alpha=ak,
                        fp8_meta=policy.fp8_meta, quant_fn=qf)
        vq = fake_quant(v, policy.bits_v, policy.group_size, alpha=av,
                        fp8_meta=policy.fp8_meta, quant_fn=qf)
        err = float(((attn(kq, vq) - ref) ** 2).mean())
        if err < best_err:
            best, best_err = m, err
    return best
