"""The port's hand-written CUDA kernels and their host side (counterpart
of ``repro.kernels``): ``kv_quant`` (bulk rows and the fused decode
append) and ``decode_attn``, each with a plain PyTorch version and launch
counters.  Kernels build from ``csrc/`` at first use
(:mod:`repro_torch.kernels._build`)."""
from __future__ import annotations


def _counters():
    from . import decode_attn, kv_quant, ops
    return (("decode_attn", decode_attn.LAUNCHES),
            ("kv_quant", kv_quant.LAUNCHES), ("fp16", ops.FP16_CALLS))


def launch_counts() -> dict:
    """{kernel: {"kernel": n, "plain": n}} for both sources; decode_attn
    also counts its block-table launches under ``"pooled"``, kv_quant its
    fused decode appends under ``"append"`` (plain: ``"append_plain"``).
    ``"fp16"`` counts the calls of the fp16 layers' route, which launches
    no kernel (``kernels.ops.FP16_CALLS``: attend, append, chunk_append)."""
    return {name: dict(d) for name, d in _counters()}


def reset_launch_counts() -> None:
    """Set every launch counter to 0."""
    for _, d in _counters():
        for k in d:
            d[k] = 0


def launch_count_delta(before: dict, after: dict) -> dict:
    """``after - before`` of two :func:`launch_counts` snapshots."""
    return {k: {c: after[k][c] - before[k].get(c, 0) for c in after[k]}
            for k in after}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (shaped as :func:`launch_counts`) to the
    counters.  A CUDA-graph replay launches the kernels its capture
    recorded without running the wrappers that count them, so the graph
    cache adds the capture's delta once per replay here (and takes it
    back off after the capture, which launches nothing)."""
    for name, d in _counters():
        for c, n in delta.get(name, {}).items():
            d[c] += n * times
