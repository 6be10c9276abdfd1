"""The program's own attribution of a traced slice's device operations to
the regions of its captured decode step.

The port records, at capture, which region of its code launched each
device operation of a graph (``repro_torch.spans.op_maps()``), and lays
that map onto a device trace itself (``repro_torch.spans.attribute``).
This is the one harness module besides ``program`` that reaches into the
port: ``program`` is left as it is, so the reach for the map and the
attribution lives here.  A program
without them (no ``repro_torch.spans``, or no map of the step) reads as
None, and so does a slice in which a whole replay does not match the
map: the metrics that read it are then left out."""
from __future__ import annotations

from typing import Iterable, Optional

GRAPH = "decode_step"


def attribution(ctx):
    """The step's attribution over the slice's whole replays, or None."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    op_map = spans.op_maps().get(GRAPH)
    if op_map is None:
        return None
    got = spans.attribute(tr.device, op_map)
    if got is None or got.replays == 0:
        return None
    return got


def ms_per_replay(ctx, names: Iterable[str]) -> Optional[float]:
    """Device ms a replay of the regions ``names`` (their layers summed);
    None where the attribution is missing or none of them ran."""
    got = attribution(ctx)
    if got is None:
        return None
    by = got.by_name()
    names = [n for n in names if n in by]
    if not names:
        return None
    return sum(by[n] for n in names) * 1e3 / got.replays
