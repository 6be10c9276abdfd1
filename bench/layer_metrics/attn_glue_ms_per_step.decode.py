"""Step layer: device ms a decode step of attention's work beyond the
port's two kernels (the regions ``attn.perm``, ``attn.mask`` and
``attn.segment``: the calibration's channel gathers, the lengths and the
packed walk's mask and block bounds, the fp sink/window segment and the
merge with the kernel's partial), from the program's own map of the
captured step over the slice's whole replays (``harness.regions``).
Silent without a map or where a replay does not match the map."""
from harness import regions


def read(ctx):
    return regions.ms_per_replay(ctx, ("attn.perm", "attn.mask",
                                       "attn.segment"))
