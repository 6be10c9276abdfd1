"""RWKV6 "Finch": attention-free time-mix with data-dependent decay (port
of ``repro.models.rwkv6``).

Prefill and training use the chunk-parallel form (GLA-style): within a
chunk of :data:`CHUNK` tokens the decayed interactions are a masked product
with cumulative log-decays, in f32; across chunks a compact (H, hd, hd)
state is carried by a plain loop over the chunks (the reference's
``lax.scan``).  Decode is the O(1) recurrence

    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The per-step log-decay is clamped to [-5, -1e-4], so the within-chunk
``exp(±Σ log w)`` factors stay inside f32 range at chunk 16.

RWKV6 has NO KV cache: its decode state (``wkv`` (B, H, hd, hd) f32 and the
token-shift rows ``x_prev``/``x_prev_ffn`` (B, 1, D)) is O(1) in the
context, so SKVQ does not apply and neither hand-written kernel runs on
this family (DESIGN.md §Arch-applicability).  :func:`time_mix_decode`
writes ``wkv`` and ``x_prev`` **in place** into the tensors it is given, so
a captured decode step replays onto the same addresses.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .config import ArchConfig
from ..distributed.sharding import (P, axis_size, current_mesh, distribute,
                                    is_dtensor, is_sharded, logical,
                                    merge_heads, run_local, spec_for,
                                    whole_heads)
from ..device import resolve_device

CHUNK = 16
_LOGW_MIN = -5.0


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros at t=0). x (B, S, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(x, sx, mu, lora_a, lora_b):
    """RWKV6 data-dependent lerp for one stream."""
    xxx = x + sx * mu[0]
    off = torch.tanh(xxx @ lora_a) @ lora_b
    return x + sx * (mu[1] + off)


def _project(x, x_prev, p, cfg: ArchConfig):
    """r, k, v, g and the clamped log-decay of every token, from the rows
    and their predecessors (shared by the full-sequence and decode
    paths)."""
    sx = x_prev - x
    r = _ddlerp(x, sx, p["mu_r"], p["lora_r_a"], p["lora_r_b"]) @ p["w_r"]
    k = _ddlerp(x, sx, p["mu_k"], p["lora_k_a"], p["lora_k_b"]) @ p["w_k"]
    v = _ddlerp(x, sx, p["mu_v"], p["lora_v_a"], p["lora_v_b"]) @ p["w_v"]
    g = F.silu(_ddlerp(x, sx, p["mu_g"], p["lora_g_a"], p["lora_g_b"])
               @ p["w_g"])
    wmix = _ddlerp(x, sx, p["mu_w"], p["lora_w_a"], p["lora_w_b"])
    logw = -torch.exp(torch.clamp(
        p["w0"] + torch.tanh(wmix @ p["lora_decay_a"]) @ p["lora_decay_b"],
        -8.0, 1.6))
    logw = torch.clamp(logw, _LOGW_MIN, -1e-4)   # f32-safe chunked form
    return r, k, v, g, logw


def _heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(..., h * hd) -> (..., h, hd); on a mesh whose shards of the last
    dim do not hold whole heads, gathered over those mesh dims first
    (``sharding.whole_heads``)."""
    return whole_heads(x, h).reshape(*x.shape[:-1], h, hd)


def wkv_chunked(r, k, v, logw, u, s0):
    """Chunk-parallel WKV. r/k/v/logw (B, S, H, hd), u (H, hd), s0 (B, H,
    hd, hd).  Returns y (B, S, H, hd) in r's dtype and the final state (B,
    H, hd, hd) f32.  S must divide by :data:`CHUNK`."""
    b, s, h, d = r.shape
    nc = s // CHUNK
    rc, kc, vc, wc = (x.reshape(b, nc, CHUNK, h, d).permute(0, 3, 1, 2, 4)
                      for x in (r, k, v, logw))       # (B, H, NC, C, hd)
    linc = torch.cumsum(wc, dim=3)                    # inclusive log decay
    lexc = linc - wc                                  # exclusive
    ltot = linc[..., -1:, :]                          # (B, H, NC, 1, hd)
    q_in = (rc * torch.exp(lexc)).float()             # decayed to t-1
    k_out = kc * torch.exp(-linc)                     # un-decayed to start
    k_fin = (kc * torch.exp(ltot - linc)).float()     # decayed to chunk end
    f32 = torch.float32
    v32 = vc.float()

    # intra-chunk (strictly lower-triangular) + u-bonus diagonal
    att = torch.einsum("bhntd,bhnsd->bhnts", q_in, k_out.float())
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    att = torch.where(tri, att, torch.zeros((), dtype=f32, device=r.device))
    bonus = torch.einsum("bhntd,bhntd->bhnt", rc.float(),
                         (u[None, :, None, None, :] * kc).float())
    y_intra = torch.einsum("bhnts,bhnsd->bhntd", att, v32)
    y_intra = y_intra + bonus[..., None] * v32

    # inter-chunk: the compact state carried across the chunks
    state = s0.float()
    decay = torch.exp(ltot.float()[..., 0, :])        # (B, H, NC, hd)
    ys = []
    for n in range(nc):
        ys.append(torch.einsum("bhtd,bhde->bhte", q_in[:, :, n], state))
        state = state * decay[:, :, n, :, None] + torch.einsum(
            "bhsd,bhse->bhde", k_fin[:, :, n], v32[:, :, n])
    y_inter = torch.stack(ys, dim=2)                  # (B, H, NC, C, hd)
    y = (y_intra + y_inter).permute(0, 2, 3, 1, 4).reshape(b, s, h, d)
    return y.to(r.dtype), state


def _wkv(r, k, v, logw, u, s0):
    """:func:`wkv_chunked`; on DTensors each rank runs it on its own batch
    rows and heads (``sharding.run_local``): its chunk loop is a Python
    loop of small ops, and the recurrence needs no other rank's data."""
    if not is_sharded(r):
        return wkv_chunked(r, k, v, logw, u, s0)
    mesh = current_mesh()
    b_ax, h_ax = spec_for("batch", "heads")
    if b_ax is not None and r.shape[0] % axis_size(mesh, b_ax):
        b_ax = None
    if h_ax is not None and r.shape[2] % axis_size(mesh, h_ax):
        h_ax = None
    x_spec, s_spec = P(b_ax, None, h_ax, None), P(b_ax, h_ax, None, None)
    if not is_dtensor(s0):
        s0 = distribute(s0, s_spec, mesh)
    if not is_dtensor(u):
        u = distribute(u, P(), mesh)
    return run_local(wkv_chunked, (r, k, v, logw, u, s0),
                     (x_spec,) * 4 + (P(h_ax, None), s_spec),
                     (x_spec, s_spec))


def wkv_naive(r, k, v, logw, u, s0):
    """Oracle: the step-by-step recurrence (the chunked form is held to
    it).  Shapes as :func:`wkv_chunked`, any S."""
    rr, kk, vv, ww = (x.float() for x in (r, k, v, logw))
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]
        ys.append(torch.einsum(
            "bhd,bhde->bhe", rr[:, t],
            state + u[None, :, :, None] * kk[:, t, :, :, None]
            * vv[:, t, :, None, :]))
        state = state * torch.exp(ww[:, t])[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def group_norm_heads(y, w, b, eps: float = 1e-5):
    """(B, S, H, hd) group norm per head, f32 statistics."""
    y32 = y.float()
    mu = y32.mean(dim=-1, keepdim=True)
    var = ((y32 - mu) ** 2).mean(dim=-1, keepdim=True)
    yn = (y32 - mu) * torch.rsqrt(var + eps)
    return (yn * w + b).to(y.dtype)


def _dims(cfg: ArchConfig):
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def time_mix(x, p, cfg: ArchConfig, state=None):
    """Full-sequence time-mix. x (B, S, D) -> (out (B, S, D), final wkv
    state (B, H, hd, hd) f32); ``state`` is the initial one (zeros by
    default).  The tail is padded to a whole chunk with zero r/k/v and a
    log-decay of -1e-4, which the final state carries as a decay of
    exp(-1e-4) a padded step, as in the reference."""
    b, s, d = x.shape
    h, hd = _dims(cfg)
    r, k, v, g, logw = _project(x, _shift(x), p, cfg)
    r, k, v, logw = (_heads(t, h, hd) for t in (r, k, v, logw))
    s0 = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state)
    pad = (-s) % CHUNK
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        logw = torch.cat([logw, torch.full((b, pad, h, hd), -1e-4,
                                           dtype=logw.dtype,
                                           device=x.device)], dim=1)
    y, s_fin = _wkv(r, k, v, logw, p["u"].reshape(h, hd), s0)
    y = group_norm_heads(y[:, :s], p["gn_w"].reshape(h, hd),
                         p["gn_b"].reshape(h, hd))
    return logical((merge_heads(y) * g) @ p["w_out"],
                   "batch", "seq", None), s_fin


def time_mix_decode(x1, p, cfg: ArchConfig, state: Dict[str, torch.Tensor]):
    """One token x1 (B, 1, D) from ``state`` ``{"wkv": (B, H, hd, hd) f32,
    "x_prev": (B, 1, D)}``: returns (y (B, 1, D), state), the state's two
    tensors updated **in place** (``copy_``): the new wkv state, and x1 as
    the next step's ``x_prev``."""
    b, _, d = x1.shape
    h, hd = _dims(cfg)
    r, k, v, g, logw = _project(x1, state["x_prev"], p, cfg)
    r, k, v, logw = (_heads(t, h, hd)[:, 0] for t in (r, k, v, logw))
    s_prev = state["wkv"]
    u = p["u"].reshape(h, hd)
    k32, v32 = k[..., None].float(), v[..., None, :].float()
    out = torch.einsum("bhd,bhde->bhe", r.float(),
                       s_prev + u[None, :, :, None] * k32 * v32)
    s_new = s_prev * torch.exp(logw.float())[..., None] + k32 * v32
    y = group_norm_heads(out[:, None].to(x1.dtype), p["gn_w"].reshape(h, hd),
                         p["gn_b"].reshape(h, hd))
    y = (merge_heads(y) * g) @ p["w_out"]
    state["wkv"].copy_(s_new)
    state["x_prev"].copy_(x1)
    return y, state


def channel_mix(x, p, x_prev=None):
    """RWKV6 FFN (squared relu with a receptance gate); ``x_prev`` (B, 1,
    D) is the decode step's predecessor row (the token shift otherwise)."""
    sx = (_shift(x) if x_prev is None else x_prev) - x
    xk = x + sx * p["mu_ffn_k"]
    xr = x + sx * p["mu_ffn_r"]
    k = torch.square(F.relu(logical(xk @ p["ffn_k"], "batch", "seq", "ff")))
    return torch.sigmoid(xr @ p["ffn_r"]) * logical(k @ p["ffn_v"],
                                                    "batch", "seq", None)


def state_shapes(batch: int, cfg: ArchConfig, dtype=torch.float32):
    """``{name: (shape, dtype)}`` of one layer's decode state: ``wkv`` f32,
    the two token-shift rows in ``dtype``."""
    h, hd = _dims(cfg)
    row = ((batch, 1, cfg.d_model), dtype)
    return {"wkv": ((batch, h, hd, hd), torch.float32), "x_prev": row,
            "x_prev_ffn": row}


def init_rwkv_state(batch: int, cfg: ArchConfig, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state (reference ``init_rwkv_state``) on ``device``
    (default CUDA; raises without a card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in state_shapes(batch, cfg, dtype).items()}
