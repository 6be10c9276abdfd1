"""Plain f32 reference of the MoE decoder (DeepSeekMoE): the dense
decoder's attention and norms (:mod:`reference.dense`), the first
``first_k_dense_replace`` layers with a dense MLP, the others with a
fine-grained expert FFN: an f32 softmax router over every routed expert,
the ``num_experts_per_tok`` largest picked and their weights renormalized
to sum to 1, each picked expert a SiLU-gated MLP, plus the shared experts
as one MLP of ``n_shared_experts`` times the expert width.

Routing is dropless, as the published model serves: every pick reaches
its expert.  Departure from the published DeepSeekMoE config, followed
because the program runs it so: the top-k weights are renormalized."""
from __future__ import annotations

from typing import Dict

import torch

from reference import dense

precise = dense.precise
gaps = dense.gaps
control_gaps = dense.control_gaps


def param_specs(cfg: dict) -> Dict[str, tuple]:
    nf, n = cfg["first_k_dense_replace"], cfg["num_hidden_layers"]
    d, e, f = (cfg["hidden_size"], cfg["n_routed_experts"],
               cfg["moe_intermediate_size"])
    fs = f * cfg["n_shared_experts"]
    nm = n - nf
    m = "layers/moe/"
    specs = {**dense.head_specs(cfg), **dense._attn_specs(cfg, "layers/", nm),
             m + "router": ((nm, d, e), 0.02),
             m + "experts_gate": ((nm, e, d, f), d ** -0.5),
             m + "experts_up": ((nm, e, d, f), d ** -0.5),
             m + "experts_down": ((nm, e, f, d), f ** -0.5),
             m + "shared_gate": ((nm, d, fs), d ** -0.5),
             m + "shared_up": ((nm, d, fs), d ** -0.5),
             m + "shared_down": ((nm, fs, d), fs ** -0.5)}
    if nf:
        specs.update(dense._attn_specs(cfg, "dense_layers/", nf))
        specs.update(dense._mlp_specs(cfg, "dense_layers/", nf,
                                      cfg["intermediate_size"]))
    return specs


def moe_ffn(x: torch.Tensor, p: dict, cfg: dict, mm) -> torch.Tensor:
    """x (N, T, d) f32 -> the layer's FFN output: dense MLP on a leading
    dense layer, else routed + shared experts."""
    if "mlp" in p:
        return dense.dense_ffn(x, p, cfg, mm)
    m = p["moe"]
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    probs = torch.softmax(xf @ m["router"].float(), dim=-1)
    vals, ids = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    wts = vals / vals.sum(dim=-1, keepdim=True)
    out = dense.silu_mlp(xf, m["shared_gate"], m["shared_up"],
                         m["shared_down"], mm)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = dense.silu_mlp(xf[rows], m["experts_gate"][e],
                           m["experts_up"][e], m["experts_down"][e], mm)
        out.index_add_(0, rows, y * wts[rows, slot][:, None])
    return out.reshape(shape)


def forward(params: dict, cfg: dict, tokens: torch.Tensor, **kw):
    return dense.forward(params, cfg, tokens, ffn=moe_ffn, **kw)
