"""Carry weights, calibration tables and caches between the JAX reference
and the port as nested dicts of numpy arrays.

The reference's params pytree (``jax.tree.map(np.asarray, params)``) maps
one-to-one: the same key names (``embed``, ``final_norm``, ``lm_head``,
``layers/{norm1,norm2,attn/{wq,wk,wv,wo_attn},mlp/{wi_gate,wi_up,wo}}``),
the stacked leading layer axis of ``layers``, and ``(d_in, d_out)``
weights — no transposes.  bf16 may arrive as a ``uint16`` view (or as
numpy's bfloat16 extension type) and is re-viewed as ``torch.bfloat16``;
FP8 metadata travels as its uint8 bit pattern.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device


def _to_torch(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    t = torch.from_numpy(np.array(a, copy=True))
    if t.dtype == torch.uint16:
        t = t.view(torch.bfloat16)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tree_from_numpy(tree, device=None, dtype=None):
    """Nested dict of numpy arrays -> same dict of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _to_torch(tree, dev, dtype)


def params_from_numpy(tree: Dict[str, Any], cfg=None, device=None,
                      dtype=None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params; ``dtype`` casts the
    floating leaves, ``cfg`` (optional) checks the layer count."""
    params = tree_from_numpy(tree, device, dtype)
    if cfg is not None:
        n = params["layers"]["norm1"]["w"].shape[0]
        if n != cfg.n_layers:
            raise ValueError(f"params hold {n} layers, config {cfg.name} "
                             f"wants {cfg.n_layers}")
    return params


def calib_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A stacked calib table of the reference -> perms as int64, clip
    factors as f32: the dtypes of ``core.calibrate.Calibration.stacked``
    and ``transformer.identity_calib``.  The port calibrates itself
    (``core.calibrate``), so this is only the bridge by which the parity
    tests feed the port the reference's tables."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        t = _to_torch(v, dev)
        out[k] = t.long() if k.startswith("perm") else t.to(torch.float32)
    return out


def tree_to_numpy(tree):
    """Tensors -> numpy (bf16 as its uint16 view), for comparisons."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()
