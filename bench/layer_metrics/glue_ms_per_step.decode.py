"""Step layer: device ms a decode step of every kernel, copy and fill that
is neither the decode attention kernel, the fused append nor a matrix
product (``counts.kernels``), over the traced steps."""
from counts import kernels


def read(ctx):
    tr, lens = ctx.get("trace"), ctx.get("traced_lengths")
    if tr is None or not lens:
        return None
    return tr.time_by(kernels.is_glue) * 1e3 / len(lens)
