"""Dense decoder-only LM: init, prefill, one decode step (port of the dense
path of ``repro.models.transformer``).

* Params are nested dicts with the reference's key names; per-layer
  weights are stacked on a leading layer axis (``params["layers"]``) and
  applied ``x @ w`` with ``(d_in, d_out)`` layouts.
* Channel reorder is applied at runtime to q/k/v after RoPE from a calib
  dict (``perm_k``/``perm_v`` (L, H_kv, D) int64, ``alpha_k``/``alpha_v``
  (L, H_kv, G) f32), as the reference serve path does (DESIGN.md §3).
  :func:`collect_kv` gives the K/V a calibration
  (``core.calibrate.calibrate_model``) runs on, and
  :func:`fuse_v_permutation` folds perm_v into the weights.
* Prefill runs full-precision attention first and then quantizes all but
  the sinks and the window (paper Sec. 3.2).  A decode step appends and
  quantizes in place, then attends through the backend (DESIGN.md §4).
* ``policy`` may be a :class:`~repro_torch.core.policy.PolicySchedule`
  (or a preset): the layers run in contiguous equal-policy bands
  (DESIGN.md §8), each with its own cache layout, quantizer, append and
  calibration slice.  The layer loop is a Python loop (the reference's
  ``lax.scan`` per band); a band's caches are layer-stacked ``{key: (L_band,
  B, ...)}`` (a pooled band's planes are ``(L_band, NP+1, BT, ...)`` beside
  ``block_tbl`` ``(L_band, B, NB)``, DESIGN.md §9).  One band keeps the
  flat ``{"scan": {key: ...}}`` structure, so a uniform schedule is
  bitwise the bare policy; several bands are keyed by their first layer
  (``{"scan": {"L000": {...}, "L001": {...}}}``).  Each layer works on
  views, so :func:`decode_step` updates the caches **in place**.

Chunked prefill (DESIGN.md §7: :func:`prefill_chunk_init`,
:func:`prefill_chunk`) streams a prompt through the cache a chunk at a
time, band by band.

Families: ``dense`` (llama, granite, and the gemma local/global stacks
with softcaps, ``qk_norm`` and a local RoPE base), ``vlm`` (qwen2-vl:
qkv bias, M-RoPE, untied head; its vision frontend is stubbed, so the
entry points take ``embeds=`` (B, S, d) in place of tokens and
``positions=`` (3, B, S); text-only M-RoPE broadcasts ``arange`` to the 3
streams), ``moe`` (deepseek-moe, granite-moe: the dense attention with
a routed-expert FFN, ``models/moe.py``; the first ``first_dense`` layers
keep a dense MLP and their params sit in a ``dense_layers`` stack, as in
the reference, read through :func:`_layer_params`), ``hybrid`` (hymba:
each block adds a Mamba head, ``models/ssm.py``, on the same normed input
and averages the two RMS-normed outputs; the cache dict of a layer
carries the head's decode state as ``ssm_conv``/``ssm_h`` beside the
SKVQ leaves), ``ssm`` (RWKV6, ``models/rwkv6.py``: attention-free, so
no SKVQ cache; its caches are the recurrent state ``{"scan": {"wkv",
"x_prev", "x_prev_ffn"}}``, layer-stacked, whatever the policy, which
it accepts and does not use) and ``encdec`` (seamless-m4t: LayerNorm
blocks, a bidirectional encoder over stub frame embeddings,
``enc_embeds=`` (B, S_enc, d), and in each decoder layer a
cross-attention whose K/V the prefill quantizes once, whole, under
``policy.without_window()``, kept under ``x_``-prefixed keys of the
layer's cache dict and never appended to).  The caches stay ONE
``"scan"`` group over all ``n_layers``, whatever ``first_dense`` is: MoE
changes no attention shape, and every serving module keys on ``"scan"``.
The reference splits its caches at ``first_dense`` into ``{"dense",
"scan"}``; the two map onto each other by concatenation along the layer
axis, and a schedule's bands here split at policy changes only (a
calibration table is sliced by absolute layer in both packages).  The
layer loop is static, so a layer's locality (its window and RoPE base)
is a Python fact, where the reference scans flag arrays.
:func:`decode_step` takes the reference's ``chunk`` and ``unroll``
levers; ``unroll=True`` slices each band's packed planes once to the
local window and lets local layers attend before their append.

Training: :func:`forward_train` is the full causal forward of every
family (full-precision ``full_attention``, the MoE aux loss summed over
layers, ``torch.utils.checkpoint`` per block under ``cfg.remat``), which
``training/train_step.py`` differentiates with autograd.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from .config import ArchConfig
from . import layers as L
from . import backends as bk
from . import moe as moe_lib
from . import rwkv6 as rwkv_lib
from . import ssm as ssm_lib
from .. import spans
from .attention import (full_attention, packed_planes,
                        prefill_block_attention, prefill_chunk_attention,
                        slice_indices, take_tokens)
from ..core.policy import (PolicySchedule, QuantPolicy, as_layer_policy,
                           as_schedule)
from ..core import kv_cache as kvc
from ..core import segments as seg
from ..core.quant import n_meta_groups
from ..device import resolve_device
from ..distributed.sharding import (P, axis_size, carry_context,
                                    current_mesh, is_sharded, local_index,
                                    logical, merge_heads, run_local,
                                    seq_whole, shard_count, spec_for,
                                    spec_of, whole_heads)

Params = Dict


FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")
# cache-dict leaves beside the SKVQ cache: a hybrid layer's SSM state and
# an enc-dec layer's cross-attention cache
_EXTRA = ("ssm_", "x_")


def _check_family(cfg: ArchConfig):
    """The port runs every family of the reference: the dense decoder, the
    vlm decoder (M-RoPE over the same blocks), the moe decoder (the same
    attention, routed-expert FFNs), the hybrid decoder (attention + Mamba
    heads), the attention-free ``ssm`` decoder (RWKV6) and the
    encoder-decoder."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port runs the {' and '.join(FAMILIES)}"
                                  f" families, got family={cfg.family!r}")


# =============================================================== init

@dataclasses.dataclass(frozen=True)
class Fill:
    """A constant leaf of :func:`param_specs`: every element ``value``."""
    value: float


ONES = Fill(1.0)
# log(arange(1, N + 1)) along the last axis: the SSM's A (reference
# ``init_ssm_params``), computed in f32 and cast
A_LOG = "a_log"
# a uniform draw in [0, 1): RWKV6's token-shift mixes (reference
# ``init_rwkv_params``)
UNIFORM = "uniform"
_STACKS = ("layers/", "dense_layers/", "enc_layers/")


def _norm_specs(cfg: ArchConfig, path: str, lead: tuple) -> Dict[str, tuple]:
    """A block norm's leaves: the RMS norm's ``w`` (zeros: the ``(1 + w)``
    gain), or LayerNorm's ``w`` (ones) and ``b`` (zeros)."""
    shape = lead + (cfg.d_model,)
    if cfg.norm == "layer":
        return {f"{path}/w": (shape, ONES), f"{path}/b": (shape, 0)}
    return {f"{path}/w": (shape, 0)}


def _attn_specs(cfg: ArchConfig, a: str, n: int) -> Dict[str, tuple]:
    """An attention's projections under ``a`` (``.../attn/`` or
    ``.../xattn/``), with the config's biases and q/k norms."""
    d, hd = cfg.d_model, cfg.head_dim
    w = lambda din, dout: ((n, din, dout), din ** -0.5)
    spec = {a + "wq": w(d, cfg.q_dim), a + "wk": w(d, cfg.kv_dim),
            a + "wv": w(d, cfg.kv_dim), a + "wo_attn": w(cfg.q_dim, d)}
    if cfg.qkv_bias:
        spec.update({a + "bq": ((n, cfg.q_dim), 0),
                     a + "bk": ((n, cfg.kv_dim), 0),
                     a + "bv": ((n, cfg.kv_dim), 0)})
    if cfg.qk_norm:
        spec.update({a + "q_norm": ((n, hd), 0), a + "k_norm": ((n, hd), 0)})
    return spec


def _ssm_specs(cfg: ArchConfig, prefix: str, n: int) -> Dict[str, tuple]:
    """A hybrid layer's Mamba head (reference ``init_ssm_params``) and the
    RMS norms of the two outputs it averages."""
    d, nst = cfg.d_model, cfg.ssm_state
    di, r = ssm_lib.inner_dim(cfg), ssm_lib.dt_rank(cfg)
    m = f"{prefix}/ssm/"
    return {m + "in_proj": ((n, d, 2 * di), d ** -0.5),
            m + "conv_w": ((n, cfg.ssm_conv, di), 0.1),
            m + "conv_b": ((n, di), 0),
            m + "x_proj": ((n, di, 2 * nst + r), di ** -0.5),
            m + "dt_proj": ((n, r, di), r ** -0.5),
            m + "dt_bias": ((n, di), Fill(-2.0)),   # softplus(-2): small dt
            m + "a_log": ((n, di, nst), A_LOG),
            m + "d_skip": ((n, di), ONES),
            m + "out_proj": ((n, di, d), di ** -0.5),
            f"{prefix}/norm_attn_out/w": ((n, d), 0),
            f"{prefix}/norm_ssm_out/w": ((n, d), 0)}


def _rwkv_specs(cfg: ArchConfig, prefix: str, n: int) -> Dict[str, tuple]:
    """An RWKV6 layer's time-mix and channel-mix leaves, at the top of the
    layer's dict beside its norms (reference ``init_rwkv_params``)."""
    d, f, rank = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_rank
    w = lambda din, dout, sc=None: ((n, din, dout), sc or din ** -0.5)
    m = f"{prefix}/"
    spec = {m + "w_r": w(d, d), m + "w_k": w(d, d), m + "w_v": w(d, d),
            m + "w_g": w(d, d), m + "w_out": w(d, d),
            m + "u": ((n, d), 0.1), m + "w0": ((n, d), Fill(-1.0)),
            m + "lora_decay_a": w(d, rank * 2),
            m + "lora_decay_b": w(rank * 2, d, 0.01),
            m + "gn_w": ((n, d), ONES), m + "gn_b": ((n, d), 0),
            m + "ffn_k": w(d, f), m + "ffn_v": w(f, d), m + "ffn_r": w(d, d),
            m + "mu_ffn_k": ((n, d), UNIFORM),
            m + "mu_ffn_r": ((n, d), UNIFORM)}
    for nm in ("r", "k", "v", "g", "w"):
        spec.update({m + f"mu_{nm}": ((n, 2, d), UNIFORM),
                     m + f"lora_{nm}_a": w(d, rank),
                     m + f"lora_{nm}_b": w(rank, d, 0.01)})
    return spec


def _stack_specs(cfg: ArchConfig, prefix: str, n: int, moe: bool,
                 cross: bool = False) -> Dict[str, tuple]:
    """The leaves of one layer stack of ``n`` layers under ``prefix``: its
    FFN (``mlp``, or ``moe`` with the router, the routed experts and the
    shared ones, at the reference's scales), attention and norms, a
    hybrid config's Mamba head, and with ``cross`` the cross-attention
    (``xattn``, ``norm_x``) of an enc-dec decoder layer."""
    d = cfg.d_model
    w = lambda din, dout: ((n, din, dout), din ** -0.5)
    if cfg.attn_free:
        return {**_norm_specs(cfg, f"{prefix}/norm1", (n,)),
                **_norm_specs(cfg, f"{prefix}/norm2", (n,)),
                **_rwkv_specs(cfg, prefix, n)}
    spec = {}
    if moe:
        e, f = cfg.n_experts, cfg.d_expert or cfg.d_ff
        m = f"{prefix}/moe/"
        spec.update({m + "router": ((n, d, e), 0.02),
                     m + "experts_up": ((n, e, d, f), d ** -0.5),
                     m + "experts_down": ((n, e, f, d), f ** -0.5)})
        if cfg.mlp_gated:
            spec[m + "experts_gate"] = ((n, e, d, f), d ** -0.5)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            spec.update({m + "shared_up": w(d, fs),
                         m + "shared_down": w(fs, d)})
            if cfg.mlp_gated:
                spec[m + "shared_gate"] = w(d, fs)
    else:
        spec.update({f"{prefix}/mlp/wi_up": w(d, cfg.d_ff),
                     f"{prefix}/mlp/wo": w(cfg.d_ff, d)})
        if cfg.mlp_gated:
            spec[f"{prefix}/mlp/wi_gate"] = w(d, cfg.d_ff)
    spec.update(_attn_specs(cfg, f"{prefix}/attn/", n))
    spec.update(_norm_specs(cfg, f"{prefix}/norm1", (n,)))
    spec.update(_norm_specs(cfg, f"{prefix}/norm2", (n,)))
    if cfg.family == "hybrid":
        spec.update(_ssm_specs(cfg, prefix, n))
    if cross:
        spec.update(_attn_specs(cfg, f"{prefix}/xattn/", n))
        spec.update(_norm_specs(cfg, f"{prefix}/norm_x", (n,)))
    return spec


def param_specs(cfg: ArchConfig) -> Dict[str, tuple]:
    """``{"path/to/leaf": (shape, init)}`` of every leaf the config's
    params hold (the reference's ``init_params`` tree), in draw order:
    ``init`` is the scale of a normal draw (0 means zeros), a :class:`Fill`
    constant, :data:`A_LOG` or :data:`UNIFORM`.  The one place that
    knows the params layout: :func:`init_params` builds it and
    ``convert.params_from_numpy`` checks a tree against it.  ``layers/``
    stacks layers ``first_dense..`` (MoE FFNs when the config has experts;
    the cross-attention of an enc-dec decoder), ``dense_layers/`` the
    first ``first_dense`` (dense FFNs), ``enc_layers/`` an enc-dec
    config's encoder (dense blocks with the config's norm) beside
    ``enc_norm``, as in the reference; an ``ssm`` layer holds its norms
    and the RWKV6 leaves (:func:`_rwkv_specs`)."""
    _check_family(cfg)
    nf, d = cfg.first_dense, cfg.d_model
    spec = {"embed": ((cfg.vocab_size, d), 0.02)}
    spec.update(_norm_specs(cfg, "final_norm", ()))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab_size), d ** -0.5)
    spec.update(_stack_specs(cfg, "layers", cfg.n_layers - nf, cfg.is_moe,
                             cross=cfg.family == "encdec"))
    if nf:
        spec.update(_stack_specs(cfg, "dense_layers", nf, False))
    if cfg.family == "encdec":
        spec.update(_stack_specs(dataclasses.replace(cfg, family="dense"),
                                 "enc_layers", cfg.n_enc_layers, False))
        spec.update(_norm_specs(cfg, "enc_norm", ()))
    return spec


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """``{"path/to/leaf": shape}`` of :func:`param_specs`."""
    return {k: shape for k, (shape, _) in param_specs(cfg).items()}


def _const_leaf(shape, init, dtype, dev) -> Optional[torch.Tensor]:
    """The leaf of a constant ``init`` (zeros, a :class:`Fill`,
    :data:`A_LOG`), or None for a drawn one (normal or uniform)."""
    if isinstance(init, Fill):
        return torch.full(shape, init.value, dtype=dtype, device=dev)
    if init == A_LOG:
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                   device=dev))
        return a.expand(shape).to(dtype).contiguous()
    if init == 0:
        return torch.zeros(shape, dtype=dtype, device=dev)
    return None


def _draw(shape, init, g, dev) -> torch.Tensor:
    """A drawn leaf in f32: uniform in [0, 1) for :data:`UNIFORM`, else a
    normal draw times the scale ``init``."""
    if init == UNIFORM:
        return torch.rand(shape, generator=g, device=dev)
    return torch.randn(shape, generator=g, device=dev) * init


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Random params with the reference's scales and constants
    (``transformer.py:49-155``, ``ssm.py:88-105``, ``rwkv6.py:182-206``),
    drawn from a seeded
    ``torch.Generator`` on ``device`` (default CUDA; raises without a card
    unless ``device="cpu"``): the leaves of :func:`param_specs`, a stacked
    weight drawn layer by layer."""
    spec = param_specs(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params: Params = {}
    for path, (shape, init) in spec.items():
        leaf = _const_leaf(shape, init, dtype, dev)
        if leaf is None and path.startswith(_STACKS):
            leaf = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                leaf[i] = _draw(shape[1:], init, g, dev).to(dtype)
        elif leaf is None:
            leaf = _draw(shape, init, g, dev).to(dtype)
        *parents, name = path.split("/")
        node = params
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return params


def _layer(tree, i: int):
    """Views of layer ``i`` of a layer-stacked dict tree."""
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _layer_params(params: Params, cfg: ArchConfig, i: int):
    """Views of absolute layer ``i``'s params, from ``dense_layers`` for
    the first ``first_dense`` layers and from ``layers`` after them."""
    nf = cfg.first_dense
    if i < nf:
        return _layer(params["dense_layers"], i)
    return _layer(params["layers"], i - nf)


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
    """Stacked no-op calibration (identity perms, alpha = 1).  ``policy`` is
    one layer's policy: the alpha group counts depend on it, so a
    non-uniform schedule builds one table per band (:func:`_band_calib`)."""
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


def stacked_calib(calib, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """A calibration object (anything with ``stacked()``) -> the stacked
    ``(L, ...)`` table the passes take (the reference's
    ``stacked_calib``)."""
    return calib.stacked()


def _apply_perm(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), perm (H, D): gather along channels."""
    return torch.gather(x, -1, perm[None, None].expand(x.shape))


def _expand_perm(perm: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    return perm.repeat_interleave(n_q_heads // perm.shape[-2], dim=-2)


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    return inv.scatter_(-1, perm, torch.arange(
        perm.shape[-1], device=perm.device).expand_as(perm).contiguous())


# ========================================================= schedule banding
# A schedule splits the layers into contiguous equal-policy BANDS (DESIGN.md
# §8): one band = one cache layout.  One band keeps the flat cache group, so
# a uniform schedule is bitwise the bare policy; several bands key the group
# by band.

def _band_key(start: int) -> str:
    """Cache-group key of the band starting at layer ``start`` (zero-padded
    so that lexicographic order is layer order)."""
    return f"L{start:03d}"


def band_keyed(group) -> bool:
    """Whether a cache group is band-keyed (a dict of stacks) rather than
    one flat stack of tensors (an RWKV6 state stack has no ``length``)."""
    return not torch.is_tensor(next(iter(group.values())))


def _first_stack(group):
    """The first band's stacked caches of a group (flat or band-keyed)."""
    return group[min(group)] if band_keyed(group) else group


def _band_cache(group, bands, start):
    """The stacked caches of the band at ``start`` within its group."""
    return group if len(bands) == 1 else group[_band_key(start)]


def _band_out(outs, bands, g0):
    """A group's per-band outputs: one band keeps the flat structure,
    several are band-keyed."""
    return outs[_band_key(g0)] if len(bands) == 1 else outs


def _band_calib(calib, cfg: ArchConfig, pol: QuantPolicy, start: int,
                stop: int, device):
    """The band's calibration: the caller's stacked ``(L, ...)`` table cut
    to ``[start, stop)`` (perms as int64), or an identity table built with
    the band's policy (alpha group counts differ across policies)."""
    if calib is None:
        return identity_calib(cfg, pol, n_layers=stop - start, device=device)
    return {k: v[start:stop].long() if k.startswith("perm") else
            v[start:stop] for k, v in calib.items()}


def _check_calib_schedule(calib, sched: PolicySchedule, cfg: ArchConfig):
    """One stacked calibration table serves only a schedule whose QUANTIZED
    layers share one quantization layout: alpha tables carry no layout, so
    slicing one across mixed-bits bands would misalign clip factors
    (DESIGN.md §8).  fp16 layers are exempt (their alphas are never read)."""
    if calib is None:
        return
    layouts = {(p.bits_k, p.bits_v, min(p.group_size, cfg.head_dim),
                p.fp8_meta) for p in sched if not p.is_fp16}
    if len(layouts) > 1:
        raise ValueError(
            f"a stacked calibration table cannot serve a schedule mixing "
            f"{len(layouts)} quantization layouts (distinct bits/group/meta "
            f"among quantized layers) — per-layer alpha plane layouts "
            f"differ; calibrate each layer against its own policy or pass "
            f"calib=None")


# =========================================================== attention sub

def _rope_tables(cfg: ArchConfig, positions):
    """The (global, local) pair of (cos, sin) tables at ``positions``
    ((3, B, S) under M-RoPE): the local pair is the global one unless the
    config gives local layers their own base (``rope_theta_local``)."""
    if cfg.mrope_sections:
        rope = L.mrope_tables(positions, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
        return rope, rope
    rope = L.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope_theta_local > 0:
        return rope, L.rope_table(positions, cfg.head_dim,
                                  cfg.rope_theta_local)
    return rope, rope


def _layer_rope(cfg: ArchConfig, ropes, i: int):
    """Layer ``i``'s tables: static, where the reference selects by a
    scanned flag (``jnp.where(is_local, local, global)``)."""
    return ropes[1] if cfg.layer_is_local(i) else ropes[0]


def _proj(x, p, w: str, bias: str):
    """``x @ p[w]``, plus ``p[bias]`` where the layer has one (qkv_bias)."""
    y = seq_whole(x) @ p[w]
    return y + p[bias] if bias in p else y


def _heads(y, n: int, cfg: ArchConfig):
    """A projection's output (B, S, n * hd) split into (B, S, n, hd); on a
    mesh whose shards of it do not hold whole heads it is gathered over
    those mesh dims first (``sharding.whole_heads``)."""
    b, s, _ = y.shape
    return whole_heads(y, n).reshape(b, s, n, cfg.head_dim)


def _qkv(x, p, cfg: ArchConfig, rope):
    """Project (+ bias), RMS-norm q and k per head (``qk_norm``, the
    ``(1 + w)`` form), rope: q, k, v (B, S, H, hd) post-rope (pre-perm)."""
    b, s, _ = x.shape
    q = logical(_heads(_proj(x, p, "wq", "bq"), cfg.n_heads, cfg),
                "batch", "seq", "heads", None)
    k = _heads(_proj(x, p, "wk", "bk"), cfg.n_kv_heads, cfg)
    v = _heads(_proj(x, p, "wv", "bv"), cfg.n_kv_heads, cfg)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _attn_out(o, p):
    """The attention output projection of o (B, S, ...) -> (B, S, d)."""
    return logical(merge_heads(o) @ p["wo_attn"], "batch", "seq", None)


def _embed_in(params: Params, cfg: ArchConfig, tokens, embeds):
    """The model's input rows: ``embeds`` (B, S, d) when the config takes
    embeddings (the stubbed vision frontend's patch embeddings), else the
    token embedding of ``tokens`` (B, S)."""
    if embeds is not None:
        if not cfg.input_embeds:
            raise ValueError(f"{cfg.name} takes tokens, not embeds")
        return embeds
    if tokens is None:
        raise ValueError("pass tokens or embeds")
    return L.embed(tokens, params["embed"], cfg.embed_scale)


def _positions(cfg: ArchConfig, s: int, positions, device):
    """Prefill positions: ``arange(s)``, or under M-RoPE the (3, B, S)
    streams given, text-only ``arange`` broadcast to (3, 1, S)."""
    if not cfg.mrope_sections:
        if positions is not None:
            raise ValueError("positions= is for M-RoPE configs")
        return torch.arange(s, dtype=torch.int32, device=device)
    if positions is not None:
        return positions
    return torch.arange(s, dtype=torch.int32, device=device).expand(3, 1, s)


def _window(cfg: ArchConfig, i: int) -> int:
    return cfg.local_window if cfg.layer_is_local(i) else 0


def _ffn(x, p, cfg: ArchConfig):
    """The layer's FFN on the normed residual: routed experts where the
    layer has ``moe`` params, else the dense MLP (the aux loss is for
    training and is not computed)."""
    if "moe" in p:
        return moe_lib.moe_ffn(x, p["moe"], cfg, with_aux=False)[0]
    return L.mlp(x, p["mlp"], cfg)


def _ffn_aux(x, p, cfg: ArchConfig):
    """:func:`_ffn` for training: (out, the layer's MoE aux loss, or f32 0
    for a dense MLP)."""
    if "moe" in p:
        return moe_lib.moe_ffn(x, p["moe"], cfg)
    return L.mlp(x, p["mlp"], cfg), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def _ffn_residual(x, p, cfg: ArchConfig):
    """``x + _ffn(norm2(x))`` of a decode step, under its regions: ``mlp``
    for a dense layer; for a MoE layer the norm under ``moe.route`` and
    the residual under ``moe.combine``, around the regions of
    :func:`moe_lib.moe_ffn`."""
    if "moe" not in p:
        with spans.region("mlp"):
            return x + L.mlp(L.norm(x, p["norm2"], cfg), p["mlp"], cfg)
    with spans.region("moe.route"):
        h = L.norm(x, p["norm2"], cfg)
    y = moe_lib.moe_ffn(h, p["moe"], cfg, with_aux=False)[0]
    with spans.region("moe.combine"):
        return x + y


def _mix_ssm(attn, sout, p, cfg: ArchConfig):
    """A hybrid block's mixer output: the mean of the RMS-normed attention
    and Mamba outputs (reference ``transformer.py:308-311``)."""
    return 0.5 * (L.rms_norm(attn, p["norm_attn_out"]["w"], cfg.norm_eps)
                  + L.rms_norm(sout, p["norm_ssm_out"]["w"], cfg.norm_eps))


def _cross_qkv(x_dec, enc_out, p, cfg: ArchConfig):
    """Cross-attention q from the decoder rows, k/v from the encoder
    output, (B, S, H, hd) each, no RoPE (reference ``_cross_qkv``)."""
    q = _heads(_proj(x_dec, p, "wq", "bq"), cfg.n_heads, cfg)
    k = _heads(_proj(enc_out, p, "wk", "bk"), cfg.n_kv_heads, cfg)
    v = _heads(_proj(enc_out, p, "wv", "bv"), cfg.n_kv_heads, cfg)
    return q, k, v


def _block_full(x, params: Params, cfg: ArchConfig, ropes, i: int,
                enc_out=None, train: bool = False):
    """Layer ``i`` over the whole sequence in full precision (the fixed
    128-wide key blocks of DESIGN.md §7): returns (x, k, v, extra) with
    k/v (B, S, H_kv, D) post-RoPE and unpermuted, the K/V the cache
    quantizes.  ``extra`` holds a hybrid layer's Mamba decode state
    (``ssm_conv``, ``ssm_h``, the cache leaves) or an enc-dec decoder
    layer's cross K/V over ``enc_out`` (``kx``, ``vx``: unpermuted, no
    RoPE); it is empty for the other families.  Shared by
    :func:`prefill_model` and :func:`collect_kv`.  ``train``
    (:func:`forward_train`) attends through ``full_attention``, as the
    reference's training forward does, keeps no decode state, and gives
    the layer's MoE aux loss (f32 0 without experts) as ``extra["aux"]``."""
    p = _layer_params(params, cfg, i)
    hn = L.norm(x, p["norm1"], cfg)
    q, k, v = _qkv(hn, p["attn"], cfg, _layer_rope(cfg, ropes, i))
    attend = full_attention if train else prefill_block_attention
    attn = attend(q, k, v, cfg, window=_window(cfg, i))
    attn = _attn_out(attn, p["attn"])
    extra = {}
    if "ssm" in p and train:
        attn = _mix_ssm(attn, ssm_lib.ssm_forward(hn, p["ssm"], cfg), p, cfg)
    elif "ssm" in p:
        sout, st = ssm_lib.ssm_forward(hn, p["ssm"], cfg, return_state=True)
        attn = _mix_ssm(attn, sout, p, cfg)
        extra = {"ssm_conv": st["conv"], "ssm_h": st["h"]}
    x = x + attn
    if "xattn" in p:
        qx, kx, vx = _cross_qkv(L.norm(x, p["norm_x"], cfg), enc_out,
                                p["xattn"], cfg)
        xo = full_attention(qx, kx, vx, cfg, bidirectional=True)
        x = x + _attn_out(xo, p["xattn"])
        extra = {} if train else {"kx": kx, "vx": vx}
    if train:
        f, aux = _ffn_aux(L.norm(x, p["norm2"], cfg), p, cfg)
        return x + f, k, v, {"aux": aux}
    x = x + _ffn(L.norm(x, p["norm2"], cfg), p, cfg)
    return x, k, v, extra


def _block_rwkv(x, p, cfg: ArchConfig):
    """One RWKV6 layer over the whole sequence (training): time-mix, then
    channel-mix, each on its normed residual.  Returns (x, f32 0), the
    aux loss of a layer without experts."""
    y, _ = rwkv_lib.time_mix(L.norm(x, p["norm1"], cfg), p, cfg)
    x = x + y
    x = x + rwkv_lib.channel_mix(L.norm(x, p["norm2"], cfg), p)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ============================================================ train forward

# the matmuls ``remat_policy="dots"`` saves: products without batch dims,
# as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    """``fn`` (one block) under the config's activation checkpointing:
    none (``remat`` off or ``remat_policy="none"``), full per-block
    recompute (``"nothing"``: only the block's input survives to the
    backward pass) or selective (``"dots"``: the matmul outputs are saved,
    the rest recomputed)."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy must be nothing, dots or none, got "
                         f"{cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    fn = carry_context(fn)
    return lambda x: ckpt.checkpoint(fn, x, use_reentrant=False, **kw)


def forward_train(params: Params, cfg: ArchConfig, batch: Dict,
                  dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full causal forward of every family (reference
    ``transformer.forward_train``) in the params' own dtype: ``batch``
    holds ``tokens`` (B, S) (or ``embeds`` (B, S, d) and M-RoPE
    ``positions`` (3, B, S) for a config with ``input_embeds``;
    ``enc_embeds`` for an enc-dec config; other keys, such as ``labels``,
    are ignored).  Attention is ``full_attention`` in full precision; the
    blocks run under :func:`_remat`.  ``dtype`` (the reference's mixed
    precision): the floating params are cast to it at use (the f32
    masters get the gradients through the cast) and so are the input
    rows.  Returns (logits (B, S, V), the MoE aux loss summed over the
    layers, an f32 scalar)."""
    _check_family(cfg)
    params = _cast_params(params, dtype)
    x = _embed_in(params, cfg, batch.get("tokens"), batch.get("embeds"))
    if dtype is not None:
        x = x.to(dtype)
    x = logical(x, "batch", "seq", None)
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.attn_free:
        blocks = [functools.partial(_block_rwkv,
                                    p=_layer_params(params, cfg, i), cfg=cfg)
                  for i in range(cfg.n_layers)]
    else:
        ropes = _rope_tables(cfg, _positions(cfg, s, batch.get("positions"),
                                             x.device))
        enc_out = _enc_out(params, cfg, batch.get("enc_embeds"))

        def block(h, i):
            h, _, _, extra = _block_full(h, params, cfg, ropes, i, enc_out,
                                         train=True)
            return h, extra["aux"]
        blocks = [functools.partial(block, i=i) for i in range(cfg.n_layers)]
    for fn in blocks:
        x, a = _remat(cfg, fn)(x)
        aux = aux + a
    x = L.norm(x, params["final_norm"], cfg)
    return L.unembed(x, params, cfg), aux


def count_params(params) -> int:
    """Elements over every leaf of a params tree."""
    if torch.is_tensor(params):
        return params.numel()
    return sum(count_params(v) for v in params.values())


def _encode(params: Params, cfg: ArchConfig, enc_embeds):
    """The enc-dec encoder over the stub frontend's frame embeddings
    ``enc_embeds`` (B, S_enc, d), cast to the params' dtype: RoPE at
    ``arange(S_enc)``, bidirectional full-attention blocks with the
    config's norm and MLP, then ``enc_norm`` (reference
    ``transformer.py:425-439``)."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         f"enc_embeds (B, S_enc, d_model)")
    x = enc_embeds.to(params["embed"].dtype)
    s = x.shape[1]
    rope = L.rope_table(torch.arange(s, dtype=torch.int32, device=x.device),
                        cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_enc_layers):
        p = _layer(params["enc_layers"], i)
        q, k, v = _qkv(L.norm(x, p["norm1"], cfg), p["attn"], cfg, rope)
        attn = full_attention(q, k, v, cfg, bidirectional=True)
        x = x + _attn_out(attn, p["attn"])
        x = x + L.mlp(L.norm(x, p["norm2"], cfg), p["mlp"], cfg)
    return L.norm(x, params["enc_norm"], cfg)


def _enc_out(params: Params, cfg: ArchConfig, enc_embeds):
    """The encoder output an enc-dec config's layers attend to, else None
    (``enc_embeds`` refused)."""
    if cfg.family == "encdec":
        return _encode(params, cfg, enc_embeds)
    if enc_embeds is not None:
        raise ValueError(f"{cfg.name} has no encoder: enc_embeds is for "
                         f"encoder-decoder configs")
    return None


def _serve_layout(hkv: int, batch: int) -> Tuple:
    """(batch axes, head axes) of a layer's cache under the current rules:
    the rules' ``batch`` and ``kv_heads`` axes, each where it divides, as
    ``launch.shardings.cache_shardings`` lays a cache out."""
    mesh = current_mesh()
    b_ax, h_ax = spec_for("batch", "kv_heads")
    if b_ax is not None and batch % axis_size(mesh, b_ax):
        b_ax = None
    if h_ax is not None and hkv % axis_size(mesh, h_ax):
        h_ax = None
    return b_ax, h_ax


def _local_heads(t, h_ax, n_heads: int):
    """This rank's heads of a per-head table ``t`` (heads first) when the
    heads are split over ``h_ax``; ``t`` itself otherwise."""
    if h_ax is None or t.shape[0] != n_heads:
        return t
    n = n_heads // axis_size(current_mesh(), h_ax)
    return t.narrow(0, local_index(h_ax) * n, n)


def _plane_spec(b_ax, h_ax):
    """The layout of a cache leaf (B, ...) of a layer: planes and fp
    segments (B, S, H, W) by batch and head axes, ``length`` (B,) by
    batch."""
    def spec(key, leaf):
        if leaf.ndim < 4:
            return P(b_ax, *([None] * (leaf.ndim - 1)))
        return P(b_ax, None, h_ax, *([None] * (leaf.ndim - 3)))
    return spec


def _quantize_kv(k, v, cal, cap: int, pol, quant_fn, dtype):
    """One layer's cache of capacity ``cap`` from its K/V: channels
    permuted by the layer's calibration ``cal`` (``perm_k``/``perm_v``
    (H, D), ``alpha_k``/``alpha_v``), then ``kv_cache.prefill``.

    On DTensors each rank quantizes its own batch rows and kv heads (its
    slice of the calibration); the packed planes are then laid out by the
    rules' ``kv_seq`` axes (context parallelism under
    ``LONG_SERVE_RULES``)."""
    if is_sharded(k):
        hkv = k.shape[2]
        b_ax, h_ax = _serve_layout(hkv, k.shape[0])
        spec = P(b_ax, None, h_ax, None)
        lcal = {n: _local_heads(t, h_ax, hkv) for n, t in cal.items()}
        out = run_local(lambda kk, vv: _quantize_kv(kk, vv, lcal, cap, pol,
                                                    quant_fn, dtype),
                        (k, v), (spec, spec), _plane_spec(b_ax, h_ax),
                        shards=shard_count(spec))
        return {n: logical(t, "batch", "kv_seq", "kv_heads", None)
                if kvc.is_plane_key(n) else t for n, t in out.items()}
    return kvc.prefill(_apply_perm(k, cal["perm_k"]).to(dtype),
                       _apply_perm(v, cal["perm_v"]).to(dtype), cap, pol,
                       cal["alpha_k"], cal["alpha_v"], quant_fn=quant_fn)


def _stack_caches(per_layer):
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


# ================================================================ prefill

def _bands(cfg: ArchConfig, policy, calib):
    """The schedule's bands over every layer, after the calib check."""
    sched = as_schedule(policy, cfg.n_layers)
    _check_calib_schedule(calib, sched, cfg)
    return sched.bands()


def prefill_model(params: Params, cfg: ArchConfig, tokens, policy,
                  calib: Optional[Dict] = None,
                  max_len: Optional[int] = None, dtype=None, backend=None,
                  *, embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  enc_embeds: Optional[torch.Tensor] = None):
    """Paper Sec. 3.2 prefill of ``tokens`` (B, S) (or, for a config with
    ``input_embeds``, of ``embeds`` (B, S, d) with ``tokens`` None):
    full-precision attention (fixed 128-wide key blocks, DESIGN.md §7),
    then quantize all but the sinks and the window through the backend's
    quantizer, band by band with each band's policy (DESIGN.md §8).
    ``positions`` (3, B, S) are the M-RoPE streams (default: ``arange``
    on each).  An enc-dec config takes ``enc_embeds`` (B, S_enc, d), the
    stub frontend's frames: the encoder runs first, and each decoder
    layer quantizes its cross K/V whole (S_enc tokens, capacity S_enc)
    under ``policy.without_window()`` with the layer's calibration and the
    band's quantizer, kept under ``x_`` keys; a hybrid layer keeps its
    Mamba state as ``ssm_conv``/``ssm_h``.

    Returns (last-token logits (B, 1, V), {"scan": caches}): layer-stacked,
    band-keyed when the schedule has more than one band.  An ``ssm``
    config (RWKV6) has no KV cache: its caches are the recurrent state
    (:func:`_prefill_rwkv`), and the policy is accepted and unused."""
    _check_family(cfg)
    bands = _bands(cfg, policy, calib)
    params = _cast_params(params, dtype)
    x = _embed_in(params, cfg, tokens, embeds)
    dev = x.device
    backend = bk.resolve_backend(backend, dev)
    if dtype is not None:
        x = x.to(dtype)
    if cfg.attn_free:
        return _prefill_rwkv(params, cfg, x)
    s = x.shape[1]
    ml = max_len or (s + 64)
    ropes = _rope_tables(cfg, _positions(cfg, s, positions, dev))
    enc_out = _enc_out(params, cfg, enc_embeds)
    outs = {}
    for bs, be, pol in bands:
        quant_fn = backend.quant_fn(pol)
        cal = _band_calib(calib, cfg, pol, bs, be, dev)
        caches = []
        for i in range(bs, be):
            x, k, v, extra = _block_full(x, params, cfg, ropes, i, enc_out)
            lc = {n: t[i - bs] for n, t in cal.items()}
            cache = _quantize_kv(k, v, lc, ml, pol, quant_fn, x.dtype)
            if "kx" in extra:
                xc = _quantize_kv(extra.pop("kx"), extra.pop("vx"), lc,
                                  enc_out.shape[1], pol.without_window(),
                                  quant_fn, x.dtype)
                cache.update({f"x_{kk}": vv for kk, vv in xc.items()})
            cache.update(extra)
            caches.append(cache)
        outs[_band_key(bs)] = _stack_caches(caches)
    x = L.norm(x, params["final_norm"], cfg)
    return (L.unembed(x[:, -1:], params, cfg),
            {"scan": _band_out(outs, bands, 0)})


def _prefill_rwkv(params: Params, cfg: ArchConfig, x):
    """The RWKV6 prefill (reference ``transformer.py:528-539``): each layer
    over the whole prompt, keeping its decode state ``{"wkv": (B, H, hd,
    hd) f32, "x_prev": the last normed time-mix input row, "x_prev_ffn":
    the last normed channel-mix input row}``.  Returns (last-token logits
    (B, 1, V), {"scan": the states stacked over the layers})."""
    caches = []
    for i in range(cfg.n_layers):
        p = _layer_params(params, cfg, i)
        hn = L.norm(x, p["norm1"], cfg)
        y, s_fin = rwkv_lib.time_mix(hn, p, cfg)
        x = x + y
        h2 = L.norm(x, p["norm2"], cfg)
        x = x + rwkv_lib.channel_mix(h2, p)
        caches.append({"wkv": s_fin, "x_prev": hn[:, -1:].clone(),
                       "x_prev_ffn": h2[:, -1:].clone()})
    x = L.norm(x, params["final_norm"], cfg)
    return L.unembed(x[:, -1:], params, cfg), {"scan": _stack_caches(caches)}


# ============================================================= collect_kv

def collect_kv(params: Params, cfg: ArchConfig, tokens,
               max_samples: int = 4096, *,
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               enc_embeds: Optional[torch.Tensor] = None):
    """Post-RoPE K/V of every layer for calibration: (L, N, H_kv, D) each,
    N = B x S tokens cut to ``max_samples``, in the params' dtype on the
    tokens' device.  The layer loop is :func:`prefill_model`'s
    (:func:`_block_full`), so calibration sees exactly the K/V that the
    cache quantizes (before the channel permutation); ``embeds``,
    ``positions`` and ``enc_embeds`` as in :func:`prefill_model`.  A
    hybrid config gives its attention K/V; an enc-dec config runs the
    encoder first and gives the decoder's self-attention K/V.  An ``ssm``
    config has no KV cache to calibrate: ``ValueError``, the reference's."""
    _check_family(cfg)
    if cfg.attn_free:
        raise ValueError("rwkv6 has no KV cache (SKVQ inapplicable)")
    x = _embed_in(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    ropes = _rope_tables(cfg, _positions(cfg, s, positions, x.device))
    enc_out = _enc_out(params, cfg, enc_embeds)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v, _ = _block_full(x, params, cfg, ropes, i, enc_out)
        ks.append(k.reshape(b * s, cfg.n_kv_heads, cfg.head_dim)[:max_samples])
        vs.append(v.reshape(b * s, cfg.n_kv_heads, cfg.head_dim)[:max_samples])
    return torch.stack(ks), torch.stack(vs)


def fuse_v_permutation(attn_params: Dict, perm_v, n_heads: int) -> Dict:
    """Fold the V permutation into ``wv`` and ``wo_attn`` (paper Appendix
    6; DESIGN.md §3): the V path has no RoPE, so the fusion is exact.  The
    input side of ``wo_attn`` follows perm_v expanded to the query heads
    (GQA).  ``attn_params`` holds one layer's weights with perm_v (H_kv,
    D), or layer-stacked ones with perm_v (L, H_kv, D); perm_v is numpy or
    a tensor.  Serve the fused weights with an identity perm_v."""
    from ..core.reorder import fuse_in_channels, fuse_out_channels, on_device
    pv = on_device(perm_v, attn_params["wv"].device).long()
    out = dict(attn_params)
    out["wv"] = fuse_out_channels(attn_params["wv"], pv)
    out["wo_attn"] = fuse_in_channels(attn_params["wo_attn"],
                                      _expand_perm(pv, n_heads))
    return out


# ========================================================== chunked prefill

def _check_chunkable(cfg: ArchConfig):
    """Chunked prefill runs the dense family without M-RoPE (the
    reference's ``_check_chunkable``, with its messages)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"chunked prefill supports the dense family only, got "
            f"family={cfg.family!r}: ssm/hybrid/encdec prefill state is not "
            f"chunk-carried yet, and moe expert capacity scales with the "
            f"token count, so a chunked run would drop different tokens "
            f"than a whole-prompt run — use whole-prompt prefill")
    if cfg.mrope_sections:
        raise NotImplementedError(
            "chunked prefill does not support M-RoPE position streams")


def prefill_chunk_init(cfg: ArchConfig, policy, max_len: int, cap: int,
                       batch: int = 1, dtype=torch.float32,
                       device=None) -> Dict:
    """Empty chunked-prefill state (DESIGN.md §7): ``{"caches": {"scan":
    zeroed layer-stacked caches (L, B, ...)}, "ws": {"scan": {"k", "v":
    (L, B, cap, H_kv, D)}}}`` in ``dtype`` on ``device``, each band-keyed
    as :func:`prefill_model` keys its caches when the schedule has several
    bands (DESIGN.md §8).  The workspace holds the prompt's unpermuted
    post-RoPE K/V at row = position, for the full-precision chunk
    attention; ``cap >= max_len`` always suffices."""
    _check_chunkable(cfg)
    if cap < max_len:
        raise ValueError(f"workspace cap ({cap}) must be >= max_len "
                         f"({max_len})")
    bands = as_schedule(policy, cfg.n_layers).bands()
    dev = resolve_device(device)
    couts, wouts = {}, {}
    for bs, be, pol in bands:
        n = be - bs
        shapes = kvc.cache_shapes(batch, max_len, cfg.n_kv_heads,
                                  cfg.head_dim, pol, dtype)
        ws = (n, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        couts[_band_key(bs)] = {k: torch.zeros((n,) + s, dtype=d,
                                               device=dev)
                                for k, (s, d) in shapes.items()}
        wouts[_band_key(bs)] = {
            "k": torch.zeros(ws, dtype=dtype, device=dev),
            "v": torch.zeros(ws, dtype=dtype, device=dev)}
    return {"caches": {"scan": _band_out(couts, bands, 0)},
            "ws": {"scan": _band_out(wouts, bands, 0)}}


def _ws_write(ws: torch.Tensor, x: torch.Tensor, t0: int, n_valid: int):
    """In place: the chunk's ``n_valid`` real rows of ``x`` (B, C, H, D)
    into workspace rows ``[t0, t0 + n_valid)``; padding rows are never
    written."""
    ws[:, t0:t0 + n_valid] = x[:, :n_valid].to(ws.dtype)


def prefill_chunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  state: Dict, policy, t0: int, n_valid: int,
                  calib: Optional[Dict] = None, dtype=None, backend=None):
    """One prompt chunk against the SKVQ cache (DESIGN.md §7).

    ``tokens`` (1, C): prompt tokens ``[t0, t0 + n_valid)`` padded to the
    bucket C; ``t0``/``n_valid`` are host ints.  Per layer, in the
    reference's order: project q/k/v with RoPE at ``t0 + i``, write the
    real rows into the workspace, attend over it
    (``prefill_chunk_attention``, full precision, cut at the frontier),
    add the residual and the MLP, then append the permuted K/V to the
    cache through the backend's ``chunk_append_fn`` for the layer's band
    (DESIGN.md §8).  ``state`` (from :func:`prefill_chunk_init` with the
    same schedule) is updated in place.  Returns (logits (1, 1, V) of row
    ``n_valid - 1``, state): after the last chunk, the prompt's last-token
    logits."""
    _check_chunkable(cfg)
    bands = _bands(cfg, policy, calib)
    t0, n_valid = int(t0), int(n_valid)
    dev = tokens.device
    backend = bk.resolve_backend(backend, dev)
    params = _cast_params(params, dtype)
    x = L.embed(tokens, params["embed"], cfg.embed_scale)
    if dtype is not None:
        x = x.to(dtype)
    x = logical(x, "batch", "seq", None)
    c = x.shape[1]
    pos, _ = seg.chunk_segment(t0, n_valid, c, device=dev)
    ropes = _rope_tables(cfg, pos)
    for bs, be, pol in bands:
        append = backend.chunk_append_fn(pol)
        cal = _band_calib(calib, cfg, pol, bs, be, dev)
        group = _band_cache(state["caches"]["scan"], bands, bs)
        ws = _band_cache(state["ws"]["scan"], bands, bs)
        for i in range(bs, be):
            j = i - bs
            p = _layer_params(params, cfg, i)
            cache = {k: v[j] for k, v in group.items()}
            hn = L.norm(x, p["norm1"], cfg)
            q, k, v = _qkv(hn, p["attn"], cfg, _layer_rope(cfg, ropes, i))
            _ws_write(ws["k"][j], k, t0, n_valid)
            _ws_write(ws["v"][j], v, t0, n_valid)
            attn = prefill_chunk_attention(q, ws["k"][j], ws["v"][j], pos,
                                           cfg, window=_window(cfg, i),
                                           frontier=t0 + n_valid)
            x = x + _attn_out(attn, p["attn"])
            x = x + _ffn(L.norm(x, p["norm2"], cfg), p, cfg)
            append(cache, _apply_perm(k, cal["perm_k"][j]).to(x.dtype),
                   _apply_perm(v, cal["perm_v"][j]).to(x.dtype), pol, t0,
                   n_valid, cal["alpha_k"][j], cal["alpha_v"][j])
    x = L.norm(x, params["final_norm"], cfg)
    last = x[:, max(0, min(n_valid, c) - 1)][:, None]
    return L.unembed(last, params, cfg), state


# ================================================================= decode

def _decode_positions(cfg: ArchConfig, t, positions):
    """Each slot's position for the step, as the table functions take it:
    (B, 1) from the cache lengths ``t`` (or ``positions``, broadcast to
    (B,)), or under M-RoPE (3, B, 1) (``positions`` as given)."""
    b = t.shape[0]
    if cfg.mrope_sections:
        return t[None, :, None].expand(3, b, 1) if positions is None \
            else positions
    pos = t if positions is None else torch.as_tensor(
        positions, device=t.device).reshape(-1).expand(b)
    return pos[:, None]


def _hoists(cfg: ArchConfig, group, bs: int, be: int) -> bool:
    """Whether the unrolled step hoists a local slice of this band: it
    has a local layer and a striped packed region longer than the local
    window (pool-major planes have no per-slot token axis; a pooled
    band's local layers take the backend's ``local_slice`` route
    instead)."""
    lw = cfg.local_window
    return (lw > 0 and "block_tbl" not in group and "qk_codes_hi" in group
            and group["qk_codes_hi"].shape[2] > lw
            and any(cfg.layer_is_local(i) for i in range(bs, be)))


def _local_hoist(cfg: ArchConfig, group, pol: QuantPolicy, t, bs: int,
                 be: int):
    """The unrolled step's hoisted local view of one band: ONE stacked
    gather of each slot's last ``local_window`` packed tokens of every
    layer, ``(k_planes, v_planes, j)`` with planes ``(L_band, B, lw, ...)``
    and ``j`` (B, lw) their packed indices, taken from the pre-step cache
    (reference ``transformer.py:923-950``).  None where the band does not
    hoist (:func:`_hoists`).  On a mesh each rank gathers from its own
    batch rows and kv heads, so the planes are laid out like the cache
    they come from; None too where the planes are split along their
    tokens (``LONG_SERVE_RULES``: each rank's local layers narrow their
    own shard to the slice instead, :func:`_context_parallel_attention`)."""
    if not _hoists(cfg, group, bs, be):
        return None
    lw = cfg.local_window
    s_q = group["qk_codes_hi"].shape[2]
    k_qt, v_qt = packed_planes(group)
    kn, vn = sorted(k_qt), sorted(v_qt)

    def hoist(t, *planes):
        gidx = slice_indices(t + 1, pol, lw, s_q)                 # (B, lw)
        return tuple(take_tokens(a, gidx) for a in planes) + (gidx,)
    planes = [k_qt[n] for n in kn] + [v_qt[n] for n in vn]
    if is_sharded(t):
        _, b_ax, s_ax, h_ax = spec_of(group["qk_codes_hi"])[:4]
        if s_ax is not None:
            return None
        ps = P(None, b_ax, None, h_ax, None)
        out = run_local(hoist, (t, *planes),
                        (P(b_ax),) + (None,) * len(planes),
                        (ps,) * len(planes) + (P(b_ax, None),))
    else:
        out = hoist(t, *planes)
    return (dict(zip(kn, out[:len(kn)])), dict(zip(vn, out[len(kn):-1])),
            out[-1])


def decode_step(params: Params, cfg: ArchConfig, token, caches, policy,
                calib: Optional[Dict] = None, dtype=None, backend=None, *,
                embeds: Optional[torch.Tensor] = None, positions=None,
                chunk: int = 0, unroll: bool = False,
                prune_blocks: bool = True):
    """One decode step for ``token`` (B, 1) (or ``embeds`` (B, 1, d)) at
    each slot's own position (``positions`` overrides it: (B,), or
    (3, B, 1) under M-RoPE).

    Band by band (DESIGN.md §8), each layer appends + quantizes the
    evicted token through the backend's ``append_fn`` for the band's
    policy, then attends through ``backend`` with that policy (DESIGN.md
    §4): each band's route and kernel launch plan are fixed by its policy,
    so a captured step stays static.  ``caches`` (as
    :func:`prefill_model` builds them) are updated **in place** and
    returned with the logits (B, 1, V).  A hybrid layer also steps its
    Mamba head from the ``ssm_`` leaves (written back in place); an
    enc-dec decoder layer attends over its ``x_`` cross cache with
    ``policy.without_window()``, the packed frames alone, and never
    appends to it (reference ``transformer.py:862-913``).

    ``chunk`` tiles the reference backend's packed walk (the kernel
    ignores it); ``prune_blocks`` toggles dead-block skipping.
    An ``ssm`` config steps its recurrent state instead
    (:func:`_decode_rwkv`): no length is read, the policy and the levers
    are accepted and unused.

    ``unroll=True`` is the reference's long-context lever for
    local-attention layers (off by default, as there): per band,
    :func:`_local_hoist` slices the packed planes once, and each local
    layer attends over its slice BEFORE its append, the current token
    riding as an fp segment (``extra_kv``, ``q_pos``), then appends; a
    local layer of a band without the hoist (a pooled band) attends after
    its append through ``local_slice``; global layers are unchanged.  As
    in the reference, the two orders differ where the policy window is
    shorter than the local window: the token the append evicts is read in
    fp before it and quantized after, so a pooled band's unrolled step is
    not the striped one's there.  On a mesh the hoist and each layer run
    on every rank's own batch rows and kv heads (:func:`_local_hoist`,
    :func:`_sharded_attention`); where the packed planes are split along
    their tokens (``LONG_SERVE_RULES``) each rank attends over the part
    of its shard inside the slice and the partials merge across the
    ranks (:func:`_context_parallel_attention`)."""
    _check_family(cfg)
    bands = _bands(cfg, policy, calib)
    with spans.region("embed"):
        params = _cast_params(params, dtype)
        x = _embed_in(params, cfg, token, embeds)
        dev = x.device
        backend = bk.resolve_backend(backend, dev)
        if dtype is not None:
            x = x.to(dtype)
        x = logical(x, "batch", "seq", None)
        if not cfg.attn_free:
            b = x.shape[0]
            # (B,) per-slot position
            t = _first_stack(caches["scan"])["length"][0]
            if unroll:
                # a view of layer 0's length, which its append bumps in
                # place; the pre-append layers read it after that, so they
                # take a copy
                t = t.clone()
            ropes = _rope_tables(cfg, _decode_positions(cfg, t, positions))
    if cfg.attn_free:
        return _decode_rwkv(params, cfg, x, caches)
    lever = {"chunk": chunk, "prune_blocks": prune_blocks}
    for bs, be, pol in bands:
        append = backend.append_fn(pol)
        with spans.region("attn.perm"):
            cal = _band_calib(calib, cfg, pol, bs, be, dev)
            perm_q = _expand_perm(cal["perm_k"], cfg.n_heads)
            inv_v = _expand_perm(_inverse_perm(cal["perm_v"]), cfg.n_heads)
        group = _band_cache(caches["scan"], bands, bs)
        pre_band = unroll and _hoists(cfg, group, bs, be)
        with spans.region("attn.mask"):
            hoist = _local_hoist(cfg, group, pol, t, bs, be) if pre_band \
                else None
        for i in range(bs, be):
            with spans.region(f"layer.{i}"):
                j = i - bs
                p = _layer_params(params, cfg, i)
                layer = {k: v[j] for k, v in group.items()}
                cache = {k: v for k, v in layer.items()
                         if not k.startswith(_EXTRA)}
                with spans.region("attn.qkv"):
                    hn = L.norm(x, p["norm1"], cfg)
                    q, k, v = _qkv(hn, p["attn"], cfg,
                                   _layer_rope(cfg, ropes, i))
                lc = {"perm_q": perm_q[j], "perm_k": cal["perm_k"][j],
                      "perm_v": cal["perm_v"][j], "inv_v": inv_v[j],
                      "alpha_k": cal["alpha_k"][j],
                      "alpha_v": cal["alpha_v"][j]}
                local = (unroll and cfg.layer_is_local(i)
                         and cfg.local_window > 0)
                pre = local and pre_band
                po = None
                if pre and hoist is not None:
                    po = ({n: a[j] for n, a in hoist[0].items()},
                          {n: a[j] for n, a in hoist[1].items()}, hoist[2])

                def body(q, k, v, cache, lc, t, po, pol=pol, append=append,
                         pre=pre, local=local, i=i):
                    with spans.region("attn.perm"):
                        qp = _apply_perm(q, lc["perm_q"])
                        kp = _apply_perm(k, lc["perm_k"])
                        vp = _apply_perm(v, lc["perm_v"])
                    if pre:
                        # pre-append: the slice holds the pre-step cache, so
                        # attend first (the current token as an fp segment),
                        # then append
                        attn = backend.attend(
                            qp, cache, cfg, pol, window=_window(cfg, i),
                            dtype=x.dtype, packed_override=po,
                            extra_kv=(kp.to(x.dtype), vp.to(x.dtype), t),
                            q_pos=t, **lever)
                        with spans.region("attn.append"):
                            append(cache, kp, vp, pol, lc["alpha_k"],
                                   lc["alpha_v"])
                    else:
                        with spans.region("attn.append"):
                            append(cache, kp, vp, pol, lc["alpha_k"],
                                   lc["alpha_v"])
                        attn = backend.attend(
                            qp, cache, cfg, pol, window=_window(cfg, i),
                            dtype=x.dtype,
                            local_slice=cfg.local_window if local else 0,
                            **lever)
                    with spans.region("attn.perm"):
                        return _apply_perm(attn, lc["inv_v"])
                if is_sharded(q):
                    attn = _sharded_attention(body, q, k, v, cache, lc, cfg,
                                              pol, backend, _window(cfg, i),
                                              x.dtype, t=t, po=po, pre=pre)
                else:
                    attn = body(q, k, v, cache, lc, t, po)
                if "ssm" in p:
                    with spans.region("ssm"):
                        sout, _ = ssm_lib.ssm_decode(
                            hn, {"conv": layer["ssm_conv"],
                                 "h": layer["ssm_h"]}, p["ssm"], cfg)
                with spans.region("attn.out"):
                    attn = _attn_out(attn, p["attn"])
                    if "ssm" in p:
                        attn = _mix_ssm(attn, sout, p, cfg)
                    x = x + attn
                if "xattn" in p:
                    # the cross cache: the packed frames alone, no fp segment
                    xcache = {k[2:]: v for k, v in layer.items()
                              if k.startswith("x_")}
                    with spans.region("xattn.q"):
                        qx = _heads(L.norm(x, p["norm_x"], cfg)
                                    @ p["xattn"]["wq"], cfg.n_heads, cfg)

                    def xbody(qx, _k, _v, xcache, lc, _t=None, _po=None,
                              pol=pol):
                        with spans.region("attn.perm"):
                            qp = _apply_perm(qx, lc["perm_q"])
                        xo = backend.attend(qp, xcache, cfg,
                                            pol.without_window(),
                                            dtype=x.dtype)
                        with spans.region("attn.perm"):
                            return _apply_perm(xo, lc["inv_v"])
                    if is_sharded(qx):
                        xo = _sharded_attention(xbody, qx, None, None, xcache,
                                                lc, cfg, pol, backend, 0,
                                                x.dtype, append=False)
                    else:
                        xo = xbody(qx, None, None, xcache, lc)
                    with spans.region("xattn.out"):
                        x = x + _attn_out(xo, p["xattn"])
                x = _ffn_residual(x, p, cfg)
    with spans.region("head"):
        x = L.norm(x, params["final_norm"], cfg)
        return L.unembed(x, params, cfg), caches


def _sharded_attention(body, q, k, v, cache, lc, cfg: ArchConfig, pol,
                       backend, window: int, dtype, append: bool = True,
                       t=None, po=None, pre: bool = False):
    """A decode layer's append and attention on DTensors: ``body`` (the
    one-device append + attend + inverse permutation) on each rank's own
    batch rows and kv heads, the layout of the cache itself, which the
    append writes in place (q/k/v are laid out to match; the calibration
    is cut to the rank's heads; the slot positions ``t`` and an unrolled
    local layer's hoisted slice ``po`` are the rank's rows of them).
    Where the packed planes are split along their tokens
    (``LONG_SERVE_RULES``: batch 1, ``kv_seq`` over the data axes)
    :func:`_context_parallel_attention` runs instead (``pre``: the
    unrolled step's pre-append protocol); ``append`` False (an enc-dec
    layer's cross cache, attended and never appended to) has no such
    route."""
    ref = cache["win_k"] if "win_k" in cache else next(
        cache[n] for n in ("qk_codes_hi", "k") if n in cache)
    b_ax, _, h_ax, _ = spec_of(ref)
    hkv, hq = cfg.n_kv_heads, cfg.n_heads
    lcl = {n: _local_heads(t, h_ax, hq if n in ("perm_q", "inv_v") else hkv)
           for n, t in lc.items()}
    keys = sorted(cache)
    spec = P(b_ax, None, h_ax, None)
    s_ax = (spec_of(cache["qk_codes_hi"])[1] if "qk_codes_hi" in cache
            else None)
    if s_ax is not None:
        if not append:
            raise NotImplementedError(
                "a cross-attention cache split along its frames")
        fn = _context_parallel_attention(keys, lcl, cfg, pol, backend,
                                         window, dtype, s_ax, pre)
        return run_local(fn, (q, k, v, *[cache[n] for n in keys]),
                         (spec, spec, spec) + (None,) * len(keys), spec)
    # a cache the layer writes in place is passed on as its own shards; a
    # cross cache (read only) is laid out by rows and heads first (the
    # cache plan splits an fp16 cross cache's head dim, as the reference's
    # does: attention needs it whole)
    leaf_specs = (None,) * len(keys) if append else tuple(
        P(b_ax, *(None,) * (cache[n].ndim - 1)) if cache[n].ndim < 4 else
        P(b_ax, None, h_ax, *(None,) * (cache[n].ndim - 3)) for n in keys)
    # the hoisted slice: planes laid out like the cache, indices by rows
    pk, pv = (sorted(po[0]), sorted(po[1])) if po is not None else ([], [])
    po_args = ([po[0][n] for n in pk] + [po[1][n] for n in pv] + [po[2]]
               if po is not None else [])
    po_specs = ((spec,) * (len(pk) + len(pv)) + (P(b_ax, None),)
                if po is not None else ())

    def fn(q, k, v, t, *rest):
        n = len(po_args)
        lpo = None
        if po is not None:
            lpo = (dict(zip(pk, rest[:len(pk)])),
                   dict(zip(pv, rest[len(pk):n - 1])), rest[n - 1])
        return body(q, k, v, dict(zip(keys, rest[n:])), lcl, t, lpo)
    return run_local(fn, (q, k, v, t, *po_args, *[cache[n] for n in keys]),
                     (spec, spec, spec, None if t is None else P(b_ax))
                     + po_specs + leaf_specs, spec)


def _context_parallel_attention(keys, lc, cfg: ArchConfig, pol, backend,
                                window: int, dtype, s_ax, pre: bool = False):
    """The local function of a context-parallel decode layer (the
    reference backend): the append writes the evicted token into the rank
    whose shard of the packed tokens holds its index
    (``decode_append(packed_span=)``; the fp segments are whole on every
    rank and written by each); each rank attends over its packed shard,
    the ``(num, m, l)`` partials merge across the ranks by logsumexp (an
    all-reduce of the max, then of the rescaled sums: ``merge_splits``'
    math), and the fp segments' partial joins last.

    ``pre`` (a local layer of the unrolled step): the layer attends
    BEFORE its append, as on one device.  The hoisted slice
    ``[st0, st0 + local_window)`` of the packed tokens may cross ranks:
    each rank attends over the part of its own shard inside it (a mask
    where the reference's GSPMD gathers), the partials merge as above,
    and the fp segments join last with the current token as one more
    segment."""
    from torch.distributed import _functional_collectives as funcol
    from ..distributed.sharding import local_scaled, mesh_group
    from .attention import _scale, fp_segment_partial, skvq_parts
    if getattr(backend, "name", None) != "reference":
        raise NotImplementedError(
            "a context-parallel cache (LONG_SERVE_RULES) is attended by the "
            "reference backend")
    n_sh = axis_size(current_mesh(), s_ax)
    group = mesh_group(s_ax)
    lw = cfg.local_window

    def fn(q, k, v, *leaves):
        c = dict(zip(keys, leaves))
        n_loc = c["qk_codes_hi"].shape[1]
        off = local_index(s_ax) * n_loc
        qp = _apply_perm(q, lc["perm_q"])
        kp = _apply_perm(k, lc["perm_k"])
        vp = _apply_perm(v, lc["perm_v"])

        def append():
            kvc.decode_append(c, kp, vp, pol, lc["alpha_k"], lc["alpha_v"],
                              packed_span=(off, n_loc * n_sh))
        if not pre:
            append()
        b, _, hq, d = qp.shape
        hkv = c["qk_codes_hi"].shape[2]
        k_qt, v_qt = packed_planes(c)
        j = torch.arange(off, off + n_loc, device=q.device)
        lens = kvc.slot_lengths(c, b)
        t_now, keep, extra = lens - 1, None, None
        if pre:
            st0 = slice_indices(lens + 1, pol, lw, n_loc * n_sh)[:, :1]
            keep = (j[None] >= st0) & (j[None] < st0 + lw)
            t_now = lens
            extra = (kp.to(dtype), vp.to(dtype), lens)
        with local_scaled(n_sh):
            _, parts = skvq_parts(qp, c, cfg, pol, window=window,
                                  dtype=dtype, packed_override=(k_qt, v_qt, j),
                                  q_pos=t_now, fp=False, packed_keep=keep)
        num, m, l = parts[0]
        m_g = funcol.all_reduce(m, "max", group)
        w = torch.exp(m - m_g)
        num = funcol.all_reduce(num * w[..., None], "sum", group)
        l = funcol.all_reduce(l * w, "sum", group)
        fp = fp_segment_partial(qp.reshape(b, hkv, hq // hkv, d), c, pol,
                                lens, t_now, seg.effective_window(window),
                                _scale(cfg), cfg.attn_softcap, dtype, extra)
        out = seg.finalize([(num, m_g, l)] + fp).reshape(b, 1, hq, d)
        if pre:
            append()
        return _apply_perm(out.to(q.dtype), lc["inv_v"])
    return fn


def _decode_rwkv(params: Params, cfg: ArchConfig, x, caches):
    """One RWKV6 step of every layer from the state stack ``caches["scan"]``
    (reference ``transformer.py:835-848``): the time-mix writes ``wkv`` and
    ``x_prev`` in place, the channel-mix reads ``x_prev_ffn`` before its
    new row is written over it.  Returns (logits (B, 1, V), caches)."""
    group = caches["scan"]
    for i in range(cfg.n_layers):
        p = _layer_params(params, cfg, i)
        hn = L.norm(x, p["norm1"], cfg)
        y, _ = rwkv_lib.time_mix_decode(
            hn, p, cfg, {"wkv": group["wkv"][i], "x_prev": group["x_prev"][i]})
        x = x + y
        h2 = L.norm(x, p["norm2"], cfg)
        x = x + rwkv_lib.channel_mix(h2, p, x_prev=group["x_prev_ffn"][i])
        group["x_prev_ffn"][i].copy_(h2)
    x = L.norm(x, params["final_norm"], cfg)
    return L.unembed(x, params, cfg), caches


def layer_cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                       policy: QuantPolicy, dtype=torch.bfloat16):
    """``{name: (shape, dtype)}`` of one layer's striped cache dict as
    :func:`prefill_model` builds it: ``kv_cache.cache_shapes``, plus a
    hybrid layer's Mamba state (``ssm_conv`` in ``dtype``, ``ssm_h`` f32,
    ``ssm.state_shapes``).  An enc-dec layer's cross cache has the shape
    of the frames the prefill got, so it is not listed.  An ``ssm`` layer
    holds its RWKV6 state alone (``rwkv6.state_shapes``), the same at any
    ``max_len`` and policy."""
    if cfg.attn_free:
        return rwkv_lib.state_shapes(batch, cfg, dtype)
    shapes = kvc.cache_shapes(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                              policy, dtype)
    if cfg.family == "hybrid":
        shapes.update(ssm_lib.state_shapes(batch, cfg, dtype))
    return shapes


def cache_bytes(caches) -> int:
    """Bytes held by a (nested, band-keyed or flat) cache dict."""
    if torch.is_tensor(caches):
        return caches.numel() * caches.element_size()
    return sum(cache_bytes(v) for v in caches.values())


def bf16_cache_bytes(cfg: ArchConfig, batch: int, max_len: int) -> int:
    """Bytes of an uncompressed bf16 K/V cache of the same capacity."""
    return 2 * 2 * cfg.n_layers * batch * max_len * cfg.kv_dim

