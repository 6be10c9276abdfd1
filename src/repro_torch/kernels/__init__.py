"""The port's hand-written CUDA kernels and their host side (counterpart
of ``repro.kernels``): ``kv_quant`` (bulk rows and the fused decode
append) and ``decode_attn``, each with a plain PyTorch version and launch
counters.  Kernels build from ``csrc/`` at first use
(:mod:`repro_torch.kernels._build`)."""
from __future__ import annotations


def launch_counts() -> dict:
    """{kernel: {"kernel": n, "plain": n}} for both sources; decode_attn
    also counts its block-table launches under ``"pooled"``, kv_quant its
    fused decode appends under ``"append"`` (plain: ``"append_plain"``)."""
    from . import decode_attn, kv_quant
    return {"decode_attn": dict(decode_attn.LAUNCHES),
            "kv_quant": dict(kv_quant.LAUNCHES)}


def reset_launch_counts() -> None:
    """Set every launch counter to 0."""
    from . import decode_attn, kv_quant
    for d in (decode_attn.LAUNCHES, kv_quant.LAUNCHES):
        for k in d:
            d[k] = 0
