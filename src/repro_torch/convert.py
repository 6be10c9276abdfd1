"""Carry weights, calibration tables and caches between the JAX reference
and the port as nested dicts of numpy arrays.

The reference's params pytree (``jax.tree.map(np.asarray, params)``) maps
one-to-one: the same key names (``embed``, ``final_norm``, ``lm_head``
when untied, ``layers/{norm1,norm2,attn/{wq,wk,wv,wo_attn},mlp/{wi_gate,
wi_up,wo}}``, and per config ``attn/{q_norm,k_norm}`` (``qk_norm``) and
``attn/{bq,bk,bv}`` (``qkv_bias``); an MoE config's ``layers`` hold
``moe/{router,experts_up,experts_gate,experts_down,shared_up,shared_gate,
shared_down}`` in place of ``mlp`` (experts ``(E, d_in, d_out)``, shared
ones as the config asks) and its first ``first_dense`` layers sit in a
``dense_layers`` stack of the same leaves with ``mlp``; a hybrid config's
``layers`` add ``ssm/{in_proj,conv_w,conv_b,x_proj,dt_proj,dt_bias,a_log,
d_skip,out_proj}`` and ``norm_attn_out``/``norm_ssm_out``; an enc-dec
config's add ``xattn/{wq,wk,wv,wo_attn}`` and ``norm_x``, beside an
``enc_layers`` stack and ``enc_norm``, every norm a LayerNorm ``{w, b}``;
an ``ssm`` (RWKV6) config's ``layers`` hold ``norm1``/``norm2`` and the
time-mix and channel-mix leaves ``w_r, w_k, w_v, w_g, w_out, u, w0,
lora_decay_a, lora_decay_b, gn_w, gn_b, ffn_k, ffn_v, ffn_r, mu_ffn_k,
mu_ffn_r`` and ``mu_X, lora_X_a, lora_X_b`` for X in r, k, v, g, w, at
the top of the layer dict),
the stacked leading layer axis of each stack, and ``(d_in, d_out)``
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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def params_from_numpy(tree: Dict[str, Any], cfg=None, device=None,
                      dtype=None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params; ``dtype`` casts the
    floating leaves.  ``cfg`` (optional) checks the tree against the
    config's ``transformer.param_shapes``: a missing or extra leaf, or one
    of another shape, raises naming the leaf."""
    params = tree_from_numpy(tree, device, dtype)
    if cfg is not None:
        from .models.transformer import param_shapes
        want = param_shapes(cfg)
        got = {k: tuple(v.shape) for k, v in _leaves(params)}
        for k in sorted(set(want) | set(got)):
            if k not in got:
                raise ValueError(f"params lack leaf {k!r} that config "
                                 f"{cfg.name} needs")
            if k not in want:
                raise ValueError(f"params hold leaf {k!r} that config "
                                 f"{cfg.name} has no use for")
            if got[k] != want[k]:
                raise ValueError(f"params leaf {k!r} has shape {got[k]}, "
                                 f"config {cfg.name} wants {want[k]}")
    return params


def train_state_from_numpy(tree: Dict[str, Any], cfg=None, device=None
                           ) -> Dict[str, Any]:
    """A reference train state (numpy leaves: ``{"params", "opt": {"m",
    "v", "step"}, "step"}`` and, with gradient compression, ``"ef"``) ->
    the port's: the params through :func:`params_from_numpy` (checked
    against ``cfg`` when given), the moments and residuals as f32 trees
    of the params' structure, the two steps as int32 0-dim tensors."""
    dev = resolve_device(device)
    params = params_from_numpy(tree["params"], cfg, dev)
    want = {k: tuple(v.shape) for k, v in _leaves(params)}

    def moments(t, what):
        out = tree_from_numpy(t, dev, torch.float32)
        got = {k: tuple(v.shape) for k, v in _leaves(out)}
        if got != want:
            raise ValueError(f"{what} does not mirror the params tree")
        return out
    step = lambda a: torch.as_tensor(np.array(a, np.int32), device=dev)
    state = {"params": params,
             "opt": {"m": moments(tree["opt"]["m"], "opt/m"),
                     "v": moments(tree["opt"]["v"], "opt/v"),
                     "step": step(tree["opt"]["step"])},
             "step": step(tree["step"])}
    if "ef" in tree:
        state["ef"] = moments(tree["ef"], "ef")
    return state


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
