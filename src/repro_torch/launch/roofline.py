"""Roofline terms of a traced step (port of ``repro.launch.roofline``).

Hardware constants: NVIDIA H100 SXM5 80 GB (each from its data sheet,
"NVIDIA H100 Tensor Core GPU" datasheet, SXM5 column) in place of the
reference's TPU v5e.

FLOPs and bytes come from ``launch.op_cost`` (global, divided by the
device count).  Collective bytes: the reference parses the compiled HLO
text; the port has none, so :class:`CollectiveCounter` counts the c10d
functional collectives as they are dispatched (DTensor's redistributions
and the port's explicit ones: ``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor``, ``all_to_all_single``, and send/recv as a
permute), at their group sizes, with the reference's ring wire factors on
the per-device result bytes:

    all-reduce      2·(n-1)/n ≈ 2  × result bytes
    all-gather        (n-1)/n ≈ 1  × result bytes
    reduce-scatter    (n-1)   ≈ n-1 × result bytes (result is the scattered shard)
    all-to-all        (n-1)/n ≈ 1  × result bytes
    collective-permute            1 × result bytes

Layers run as a Python loop, so every layer's collectives are seen: no
loop multiplier.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# bf16 dense tensor-core peak, SXM5 (the data sheet's 1979 TFLOPS is with
# 2:4 sparsity; dense is half)
PEAK_FLOPS = 989e12
# HBM3, SXM5: 3.35 TB/s
HBM_BW = 3.35e12
# f32 outside the tensor cores, SXM5: 67 TFLOPS
F32_PEAK_FLOPS = 67e12
# NVLink 4, SXM5: 900 GB/s total, 450 GB/s each way (in place of the
# reference's ICI_BW)
NVLINK_BW = 450e9
# the card's device memory in GiB (80 GB HBM3), for the report's "fits?"
# (the reference tests the v5e's 16)
DEVICE_MEMORY_GIB = 80

_FACTORS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _kind_of(func, args):
    """(kind, per-device result bytes, group size) of a collective op, or
    None for any other op."""
    name = func._overloadpacket.__name__
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d"):
        return None
    x = args[0]
    if isinstance(x, (list, tuple)):
        x = x[0]
    if not isinstance(x, torch.Tensor):
        return None
    nbytes = x.numel() * x.element_size()
    if name == "all_gather_into_tensor":
        n = int(args[1])
        return "all-gather", nbytes * n, n
    if name == "all_reduce":
        return "all-reduce", nbytes, _group_size(args[2])
    if name == "reduce_scatter_tensor":
        n = int(args[2])
        return "reduce-scatter", nbytes // max(n, 1), n
    if name == "all_to_all_single":
        return "all-to-all", nbytes, _group_size(args[3])
    if name in ("send", "recv_", "recv_any_source_"):
        return "collective-permute", nbytes, 2
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched inside it, per device: wire
    bytes by kind (``collective_stats``' layout: ``{"wire_bytes",
    "by_kind": {kind: {"bytes", "n"}}, "count"}``).  It lets DTensor run
    first (``NotImplemented`` for an op on DTensors), so the
    redistributions DTensor puts in reach it as the collectives they
    are."""

    def __init__(self):
        super().__init__()
        self.stats = {"wire_bytes": 0.0, "by_kind": {}, "count": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.OpOverload):
            got = _kind_of(func, args)
            if got is not None:
                kind, nbytes, n = got
                wire = nbytes * (max(n - 1, 1) if kind == "reduce-scatter"
                                 else _FACTORS[kind])
                self.stats["wire_bytes"] += wire
                k = self.stats["by_kind"].setdefault(kind, {"bytes": 0.0,
                                                            "n": 0})
                k["bytes"] += wire
                k["n"] += 1
                self.stats["count"] += 1
        return out


def collective_stats(counter: CollectiveCounter) -> Dict:
    """Per-device wire bytes by collective kind, + op counts (the
    reference parses them from HLO text)."""
    return counter.stats


@dataclasses.dataclass
class Roofline:
    flops: float              # per device
    hbm_bytes: float          # per device
    wire_bytes: float         # per device
    peak_memory: int          # per device
    model_flops: float = 0.0  # analytic useful flops per device

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.wire_bytes / NVLINK_BW

    @property
    def dominant(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def bound_time(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self):
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self):
        """MODEL_FLOPS-time / bound-time: how close the cell runs to the
        compute roofline if the dominant term were the wall clock."""
        if self.bound_time == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_time

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes, "peak_memory": self.peak_memory,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(op_costs: Dict, wire_bytes: float = 0.0,
                peak_memory: int = 0, model_flops_per_device: float = 0.0,
                n_devices: int = 1) -> Roofline:
    """A :class:`Roofline` from ``op_cost``'s global ``{"flops",
    "bytes"}`` (divided by ``n_devices``), the per-device wire bytes of a
    :class:`CollectiveCounter` and the per-device peak memory (in place of
    the reference's ``from_compiled``)."""
    return Roofline(flops=op_costs["flops"] / n_devices,
                    hbm_bytes=op_costs["bytes"] / n_devices,
                    wire_bytes=float(wire_bytes),
                    peak_memory=int(peak_memory),
                    model_flops=model_flops_per_device)


# ------------------------------------------------ analytic MODEL_FLOPS per cell

def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode) + attention terms.

    N counts ACTIVE non-embedding params (MoE: shared + top_k routed).
    Local-attention layers contribute min(seq, window) context.
    """
    d, hd = cfg.d_model, cfg.head_dim
    # per-layer active param count
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    if cfg.family == "ssm":
        attn = 5 * d * d  # rwkv r/k/v/g/out projections
    n_layers = cfg.n_layers
    per_layer = []
    for i in range(n_layers):
        if cfg.is_moe and i >= cfg.first_dense:
            f = cfg.d_expert or cfg.d_ff
            nmlp = (3 if cfg.mlp_gated else 2) * d * f * (
                cfg.top_k + cfg.n_shared_experts)
        elif cfg.family == "ssm":
            nmlp = 2 * d * cfg.d_ff + d * d  # rwkv channel-mix k/v + r gate
        else:
            nmlp = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        extra = 0
        if cfg.family == "hybrid":
            di = d * cfg.ssm_expand
            extra = 2 * d * di + di * d  # in/out proj dominate
        if cfg.family == "encdec":
            extra = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d  # cross
        per_layer.append(attn + nmlp + extra)
    n_active = sum(per_layer) + 2 * cfg.vocab_size * d * 0  # embeddings excluded
    unembed = cfg.vocab_size * d

    def attn_ctx(s):
        tot = 0
        for i in range(n_layers):
            w = cfg.local_window if cfg.layer_is_local(i) else 0
            ctx = min(s, w) if w else s
            tot += ctx
        return tot / n_layers  # average context per layer

    hq = cfg.n_heads * hd
    if kind == "train":
        toks = batch * seq
        flops = 6 * (n_active + unembed) * toks
        if cfg.family != "ssm":
            flops += 6 * n_layers * batch * seq * attn_ctx(seq) * hq * 0.5 * 2
        return flops
    if kind == "prefill":
        toks = batch * seq
        flops = 2 * (n_active + unembed) * toks
        if cfg.family != "ssm":
            flops += 2 * n_layers * batch * seq * attn_ctx(seq) * hq * 0.5 * 2
        return flops
    # decode: one token against a seq-long cache
    flops = 2 * (n_active + unembed) * batch
    if cfg.family != "ssm":
        flops += 4 * n_layers * batch * attn_ctx(seq) * hq
    return flops
