"""Step layer: device ms a decode step of the MoE routing, dispatch and
combine (the regions ``moe.route``, ``moe.dispatch`` and ``moe.combine``
of every MoE layer: the router, the one-hots, the dispatch and combine
products and their layout copies, the residual), from the program's own
map of the captured step over the slice's whole replays
(``harness.regions``).  Silent without a map, on a dense model, or where
a replay does not match the map."""
from harness import regions


def read(ctx):
    return regions.ms_per_replay(ctx, ("moe.route", "moe.dispatch",
                                       "moe.combine"))
