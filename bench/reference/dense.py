"""Plain f32 reference of the dense decoder (llama-style: RMS norm with a
``(1 + w)`` gain, rotate-half RoPE, grouped-query attention, SiLU-gated
MLP, tied or separate output head) over an SKVQ cache.  Plain PyTorch:
it imports nothing of the program and takes only what the benchmark made
(the weights it drew, the cache K/V it drew, the token ids).

:func:`forward` runs teacher-forced: given a sequence's inputs and the
tokens the program served, every position's logits come from one causal
pass, layer by layer, in which each decoded query reads the keys that
the program's cache held quantized at its step, quantized here again
(:mod:`skvq`).  Arithmetic is f32 throughout; the K and V a token leaves
in the cache are rounded to the configuration's ``dtype`` first, since
that is what the cache stores and what its quantizer reads.
``lower=True`` is the control: every matrix product in
fp8 E4M3 (weights per output channel, activations per token), the
precision step below the configuration's bf16.

Departures from the published models, followed because the program
runs them so: RMS norm eps and gains as the configuration file states."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from reference import skvq

FP8_MAX = 448.0


def precise() -> None:
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _attn_specs(cfg: dict, pre: str, n: int) -> Dict[str, tuple]:
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    qd, kd = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return {pre + "attn/wq": ((n, d, qd), d ** -0.5),
            pre + "attn/wk": ((n, d, kd), d ** -0.5),
            pre + "attn/wv": ((n, d, kd), d ** -0.5),
            pre + "attn/wo_attn": ((n, qd, d), qd ** -0.5),
            pre + "norm1/w": ((n, d), 0), pre + "norm2/w": ((n, d), 0)}


def _mlp_specs(cfg: dict, pre: str, n: int, f: int) -> Dict[str, tuple]:
    d = cfg["hidden_size"]
    return {pre + "mlp/wi_gate": ((n, d, f), d ** -0.5),
            pre + "mlp/wi_up": ((n, d, f), d ** -0.5),
            pre + "mlp/wo": ((n, f, d), f ** -0.5)}


def head_specs(cfg: dict) -> Dict[str, tuple]:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    out = {"embed": ((v, d), 0.02), "final_norm/w": ((d,), 0)}
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = ((d, v), d ** -0.5)
    return out


def param_specs(cfg: dict) -> Dict[str, tuple]:
    """``{path: (shape, scale)}`` of every weight, layer-stacked, under the
    names the program takes them by."""
    n = cfg["num_hidden_layers"]
    return {**head_specs(cfg), **_attn_specs(cfg, "layers/", n),
            **_mlp_specs(cfg, "layers/", n, cfg["intermediate_size"])}


# ------------------------------------------------------------------ math

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def matmul(lower: bool) -> Callable:
    """``x @ w`` in f32, or (the control) with both operands rounded
    through fp8: x per row, w per output column."""
    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if lower:
            return _fp8(x, -1) @ _fp8(w, -2)
        return x @ w
    return mm


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())


def rope_tables(pos: torch.Tensor, d: int, theta: float):
    half = d // 2
    idx = torch.arange(half, dtype=torch.float32, device=pos.device)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=pos.device), -idx / half)
    ang = pos.float()[:, None] * freq
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (N, T, H, D), cos/sin (T, D/2): the rotate-half form."""
    c, s = cos[None, :, None], sin[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def silu_mlp(x, gate, up, down, mm):
    return mm(torch.nn.functional.silu(mm(x, gate)) * mm(x, up), down)


def dense_ffn(x: torch.Tensor, p: dict, cfg: dict, mm) -> torch.Tensor:
    m = p["mlp"]
    return silu_mlp(x, m["wi_gate"], m["wi_up"], m["wo"], mm)


def layer_params(params: dict, cfg: dict, i: int) -> dict:
    nf = cfg.get("first_k_dense_replace", 0)
    stack, j = (params["dense_layers"], i) if i < nf else \
        (params["layers"], i - nf)
    return _index(stack, j)


def _index(tree, j):
    if torch.is_tensor(tree):
        return tree[j]
    return {k: _index(v, j) for k, v in tree.items()}


# --------------------------------------------------------------- forward

def forward(params: dict, cfg: dict, tokens: torch.Tensor, *, p0: int = 0,
            prefix: Optional[Callable] = None, qstart: int = 0,
            out_from: int = 0, lower: bool = False,
            ffn: Callable = dense_ffn) -> torch.Tensor:
    """Logits (N, T - out_from, V) f32 of ``tokens`` (N, T) at positions
    ``p0 .. p0 + T - 1``.

    ``prefix(n, layer) -> (k, v)`` (1, p0, Hkv, D) gives sequence ``n``'s
    cached K/V of positions ``0 .. p0 - 1`` (a decode cell's filled
    cache); queries at positions ``>= qstart`` are decoded ones
    (:mod:`skvq`).  Layer by layer over every position at once."""
    precise()
    mm = matmul(lower)
    n, t = tokens.shape
    d, hq, hkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    eps, pol = cfg["rms_norm_eps"], cfg["policy"]
    scale = hd ** -0.5
    store = getattr(torch, cfg["dtype"])
    x = params["embed"][tokens].float()
    cos, sin = rope_tables(torch.arange(p0, p0 + t, device=x.device), hd,
                           cfg["rope_theta"])
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params, cfg, i)
        a = p["attn"]
        h = rms_norm(x, p["norm1"]["w"], eps)
        q = rope(mm(h, a["wq"]).reshape(n, t, hq, hd), cos, sin)
        k = rope(mm(h, a["wk"]).reshape(n, t, hkv, hd), cos, sin)
        v = mm(h, a["wv"]).reshape(n, t, hkv, hd)
        # the cache stores K and V in the configuration's type
        k, v = k.to(store).float(), v.to(store).float()
        o = torch.empty_like(q)
        for s in range(n):
            ks, vs = k[s], v[s]
            if p0:
                kp, vp = prefix(s, i)
                ks = torch.cat([kp[0].float(), ks])
                vs = torch.cat([vp[0].float(), vs])
            o[s] = skvq.attend(q[s], ks, vs, p0, qstart, pol, scale)
        x = x + mm(o.reshape(n, t, hq * hd), a["wo_attn"])
        x = x + ffn(rms_norm(x, p["norm2"]["w"], eps), p, cfg, mm)
    x = rms_norm(x[:, out_from:], params["final_norm"]["w"], eps)
    w = params["embed"].T if cfg["tie_word_embeddings"] else params["lm_head"]
    return mm(x, w)


def gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best:
    logits (..., V) f32, served (...) ids -> (...) >= 0."""
    best = logits.amax(dim=-1)
    got = logits.gather(-1, served[..., None].long())[..., 0]
    return best - got


def control_gaps(ref: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The gap, in the reference's logits, of the token the lower
    precision puts first at each position."""
    return gaps(ref, low.argmax(dim=-1))
