"""Products layer: device ms a decode step of the cuBLAS / CUTLASS matrix
products (``counts.kernels``), over the traced steps."""
from counts import kernels


def read(ctx):
    tr, lens = ctx.get("trace"), ctx.get("traced_lengths")
    if tr is None or not lens:
        return None
    t = tr.time_by(kernels.is_gemm)
    return t * 1e3 / len(lens) if t > 0 else None
