"""Dense decoder-only LM: init, prefill, one decode step (port of the dense
path of ``repro.models.transformer``).

* Params are nested dicts with the reference's key names; per-layer
  weights are stacked on a leading layer axis (``params["layers"]``) and
  applied ``x @ w`` with ``(d_in, d_out)`` layouts.
* Channel reorder is applied at runtime to q/k/v after RoPE from a calib
  dict (``perm_k``/``perm_v`` (L, H_kv, D) int64, ``alpha_k``/``alpha_v``
  (L, H_kv, G) f32), as the reference serve path does (DESIGN.md §3).
* Prefill runs full-precision attention first and then quantizes all but
  the sinks and the window (paper Sec. 3.2).  A decode step appends and
  quantizes in place, then attends through the backend (DESIGN.md §4).
* The layer loop is a Python loop (the reference's ``lax.scan``); caches
  are layer-stacked ``{"scan": {key: (L, B, ...)}}`` and each layer works
  on views, so :func:`decode_step` updates them **in place**.

Only the dense family with a uniform policy is ported; ``unroll``,
``chunk``, schedules and chunked prefill come later.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ArchConfig
from . import layers as L
from . import backends as bk
from .attention import prefill_block_attention
from ..core.policy import QuantPolicy, as_layer_policy
from ..core import kv_cache as kvc
from ..core.quant import n_meta_groups
from ..device import resolve_device

Params = Dict


def _check_dense(cfg: ArchConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"the port runs the dense family only, "
                                  f"got family={cfg.family!r}")


# =============================================================== init

def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Random params with the reference's scales (``transformer.py:49-155``),
    drawn from a seeded ``torch.Generator`` on ``device`` (default CUDA;
    raises without a card unless ``device="cpu"``)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def stacked(din, dout):
        out = torch.empty((n, din, dout), dtype=dtype, device=dev)
        for i in range(n):
            out[i] = normal((din, dout), din ** -0.5)
        return out

    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    params: Params = {"embed": normal((cfg.vocab_size, d), 0.02),
                      "final_norm": {"w": zeros(d)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    mlp = {"wi_up": stacked(d, f), "wo": stacked(f, d)}
    if cfg.mlp_gated:
        mlp["wi_gate"] = stacked(d, f)
    params["layers"] = {
        "norm1": {"w": zeros(n, d)}, "norm2": {"w": zeros(n, d)},
        "attn": {"wq": stacked(d, cfg.q_dim), "wk": stacked(d, cfg.kv_dim),
                 "wv": stacked(d, cfg.kv_dim),
                 "wo_attn": stacked(cfg.q_dim, d)},
        "mlp": mlp}
    return params


def _layer(tree, i: int):
    """Views of layer ``i`` of a layer-stacked dict tree."""
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _cast_params(params, dtype):
    if dtype is None:
        return params
    if torch.is_tensor(params):
        return params.to(dtype) if params.is_floating_point() else params
    return {k: _cast_params(v, dtype) for k, v in params.items()}


# ======================================================== calibration

def identity_calib(cfg: ArchConfig, policy: QuantPolicy,
                   n_layers: Optional[int] = None, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Stacked no-op calibration (identity perms, alpha = 1)."""
    policy = as_layer_policy(policy)
    dev = resolve_device(device)
    n = cfg.n_layers if n_layers is None else n_layers
    hd, h = cfg.head_dim, cfg.n_kv_heads
    gs = min(policy.group_size, hd)
    gk = n_meta_groups(hd, policy.bits_k, gs)
    gv = n_meta_groups(hd, policy.bits_v, gs)
    eye = torch.arange(hd, device=dev).expand(n, h, hd).contiguous()
    return {"perm_k": eye, "perm_v": eye.clone(),
            "alpha_k": torch.ones((n, h, gk), dtype=torch.float32, device=dev),
            "alpha_v": torch.ones((n, h, gv), dtype=torch.float32, device=dev)}


def _apply_perm(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), perm (H, D): gather along channels."""
    return torch.gather(x, -1, perm[None, None].expand(x.shape))


def _expand_perm(perm: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    return perm.repeat_interleave(n_q_heads // perm.shape[-2], dim=-2)


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    return inv.scatter_(-1, perm, torch.arange(
        perm.shape[-1], device=perm.device).expand_as(perm).contiguous())


def _calib(calib, cfg: ArchConfig, policy: QuantPolicy, device):
    c = identity_calib(cfg, policy, device=device) if calib is None else calib
    out = dict(c)
    out["perm_k"] = c["perm_k"].long()
    out["perm_v"] = c["perm_v"].long()
    return out


# =========================================================== attention sub

def _rope_tables(cfg: ArchConfig, positions):
    return L.rope_table(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(x, p, cfg: ArchConfig, rope):
    """Project + rope: q, k, v (B, S, H, hd) post-rope (pre-perm)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    cos, sin = rope
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _window(cfg: ArchConfig, i: int) -> int:
    return cfg.local_window if cfg.layer_is_local(i) else 0


def _stack_caches(per_layer):
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


# ================================================================ prefill

def prefill_model(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  policy: QuantPolicy, calib: Optional[Dict] = None,
                  max_len: Optional[int] = None, dtype=None, backend=None):
    """Paper Sec. 3.2 prefill of ``tokens`` (B, S): full-precision attention
    (fixed 128-wide key blocks, DESIGN.md §7), then quantize all but the
    sinks and the window through the backend's quantizer.

    Returns (last-token logits (B, 1, V), {"scan": layer-stacked caches})."""
    _check_dense(cfg)
    policy = as_layer_policy(policy)
    dev = tokens.device
    backend = bk.resolve_backend(backend, dev)
    quant_fn = backend.quant_fn(policy)
    params = _cast_params(params, dtype)
    cal = _calib(calib, cfg, policy, dev)
    x = L.embed(tokens, params["embed"], cfg.embed_scale)
    if dtype is not None:
        x = x.to(dtype)
    b, s, _ = x.shape
    ml = max_len or (s + 64)
    rope = _rope_tables(cfg, torch.arange(s, dtype=torch.int32, device=dev))
    caches = []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        hn = L.rms_norm(x, p["norm1"]["w"], cfg.norm_eps)
        q, k, v = _qkv(hn, p["attn"], cfg, rope)
        attn = prefill_block_attention(q, k, v, cfg, window=_window(cfg, i))
        x = x + attn.reshape(b, s, -1) @ p["attn"]["wo_attn"]
        x = x + L.mlp(L.rms_norm(x, p["norm2"]["w"], cfg.norm_eps),
                      p["mlp"], cfg)
        caches.append(kvc.prefill(
            _apply_perm(k, cal["perm_k"][i]).to(x.dtype),
            _apply_perm(v, cal["perm_v"][i]).to(x.dtype), ml, policy,
            cal["alpha_k"][i], cal["alpha_v"][i], quant_fn=quant_fn))
    x = L.rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return L.unembed(x[:, -1:], params, cfg), {"scan": _stack_caches(caches)}


# ================================================================= decode

def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                caches, policy: QuantPolicy, calib: Optional[Dict] = None,
                dtype=None, backend=None):
    """One decode step for ``token`` (B, 1) at each slot's own position.

    Appends + quantizes the evicted token in every layer, then attends
    through ``backend`` (DESIGN.md §4).  ``caches`` is updated **in place**
    and returned with the logits (B, 1, V)."""
    _check_dense(cfg)
    policy = as_layer_policy(policy)
    dev = token.device
    backend = bk.resolve_backend(backend, dev)
    quant_fn = backend.quant_fn(policy)
    params = _cast_params(params, dtype)
    cal = _calib(calib, cfg, policy, dev)
    perm_q = _expand_perm(cal["perm_k"], cfg.n_heads)
    inv_v = _expand_perm(_inverse_perm(cal["perm_v"]), cfg.n_heads)
    x = L.embed(token, params["embed"], cfg.embed_scale)
    if dtype is not None:
        x = x.to(dtype)
    b = x.shape[0]
    group = caches["scan"]
    t = group["length"][0]                          # (B,) per-slot position
    rope = _rope_tables(cfg, t[:, None])
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        cache = {k: v[i] for k, v in group.items()}
        hn = L.rms_norm(x, p["norm1"]["w"], cfg.norm_eps)
        q, k, v = _qkv(hn, p["attn"], cfg, rope)
        kvc.decode_append(cache, _apply_perm(k, cal["perm_k"][i]),
                          _apply_perm(v, cal["perm_v"][i]), policy,
                          cal["alpha_k"][i], cal["alpha_v"][i],
                          quant_fn=quant_fn)
        attn = backend.attend(_apply_perm(q, perm_q[i]), cache, cfg, policy,
                              window=_window(cfg, i), dtype=x.dtype)
        attn = _apply_perm(attn, inv_v[i])
        x = x + attn.reshape(b, 1, -1) @ p["attn"]["wo_attn"]
        x = x + L.mlp(L.rms_norm(x, p["norm2"]["w"], cfg.norm_eps),
                      p["mlp"], cfg)
    x = L.rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return L.unembed(x, params, cfg), caches


def cache_bytes(caches) -> int:
    """Bytes held by a (nested) cache dict."""
    if torch.is_tensor(caches):
        return caches.numel() * caches.element_size()
    return sum(cache_bytes(v) for v in caches.values())


def bf16_cache_bytes(cfg: ArchConfig, batch: int, max_len: int) -> int:
    """Bytes of an uncompressed bf16 K/V cache of the same capacity."""
    return 2 * 2 * cfg.n_layers * batch * max_len * cfg.kv_dim

