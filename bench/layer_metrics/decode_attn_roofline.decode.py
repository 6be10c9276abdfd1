"""Kernels layer: the least time of the decode attention kernel's launches
in the traced steps (one a layer a step, over every slot: the larger of
its bytes over the HBM rate and its FLOPs over the bf16 peak, by the
fixed formulas of ``counts.work``) over the device time of the split
kernel and its merge, in %.  Silent when the kernel did not run."""
from counts import h100, kernels, work


def read(ctx):
    tr, lens = ctx.get("trace"), ctx.get("traced_lengths")
    if tr is None or not lens:
        return None
    t = tr.time_by(kernels.is_decode_attn)
    if t <= 0:
        return None
    cfg = ctx["config"]
    bound = cfg["num_hidden_layers"] * sum(
        h100.bound_seconds(sum(work.decode_attn_flops(cfg, n) for n in step),
                           sum(work.decode_attn_bytes(cfg, n) for n in step))
        for step in lens)
    return 100.0 * bound / t
