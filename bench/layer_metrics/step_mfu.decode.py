"""Step layer: the model FLOPs of the traced decode steps (the fixed
count of ``counts.work``, from the configuration and each slot's live
length) over the traced slice's seconds and the card's bf16 peak, in %."""
from counts import h100, work


def read(ctx):
    tr, lens = ctx.get("trace"), ctx.get("traced_lengths")
    if tr is None or not lens:
        return None
    flops = sum(work.step_flops(ctx["config"], step) for step in lens)
    return 100.0 * flops / (tr.window_s * h100.PEAK_BF16_FLOPS)
