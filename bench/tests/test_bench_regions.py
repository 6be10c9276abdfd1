"""The two readers of the program's region map
(``attn_glue_ms_per_step.decode``, ``moe_dispatch_ms_per_step.decode``)
on a synthetic trace and map, and their silence without a map, without
the program's ``spans`` module, or where a replay does not match the
map."""
import builtins

import pytest

from harness import manifest, regions
from harness.tracing import Trace
from repro_torch import spans

M = manifest.load_manifest()
READERS = manifest.Cell(M, "dsmoe16b.batch_decode").layer_readers()
GLUE = READERS["attn_glue_ms_per_step.decode"]
MOE = READERS["moe_dispatch_ms_per_step.decode"]

# one MoE layer: perm 1 op, mask 1, kernel 1, segment 1, route 1,
# dispatch 2, experts 1, combine 1; an op under the layer alone (other)
ROWS = (("embed", 0, 1), ("layer.0", 1, 10), ("layer.0/attn.perm", 1, 1),
        ("layer.0/attn.mask", 2, 1), ("layer.0/attn.kernel", 3, 1),
        ("layer.0/attn.segment", 4, 1), ("layer.0/moe.route", 5, 1),
        ("layer.0/moe.dispatch", 6, 2), ("layer.0/moe.experts", 8, 1),
        ("layer.0/moe.combine", 9, 1), ("head", 11, 1))
MAP = spans.OpMap(tuple(spans.Row(*r) for r in ROWS), 12)
DUR = [1, 10, 20, 300, 40, 5, 60, 70, 900, 8, 2, 3]     # us, op by op


def _trace(replays=3, drop=None):
    ops, t = [("cut_tail", 0.0, 5.0), (spans.END, 5.0, 1.0)], 10.0
    for r in range(replays):
        ops.append((spans.BEGIN, t, 1.0))
        t += 1.0
        for i, d in enumerate(DUR):
            if (r, i) != drop:
                ops.append((f"k{i}", t, float(d)))
            t += d
        ops.append((spans.END, t, 1.0))
        t += 50.0
    ops += [(spans.BEGIN, t, 1.0), ("cut_head", t + 1.0, 9.0)]
    return Trace(ops, [], (0.0, t + 10.0))


@pytest.fixture
def step_map(monkeypatch):
    monkeypatch.setitem(spans._MAPS, regions.GRAPH, MAP)


def test_readers_per_replay(step_map):
    ctx = {"trace": _trace(), "traced_lengths": [[1]] * 7}
    assert GLUE.read(ctx) == pytest.approx((10 + 20 + 40) * 1e-3)
    assert MOE.read(ctx) == pytest.approx((5 + 60 + 70 + 8) * 1e-3)
    got = regions.attribution(ctx)
    assert got.replays == 3
    assert got.seconds[spans.OTHER] == pytest.approx(3 * 2e-6)


def test_moe_reader_silent_on_a_dense_map(monkeypatch):
    dense = spans.OpMap(tuple(r for r in MAP.rows
                              if "moe." not in r.path), 12)
    monkeypatch.setitem(spans._MAPS, regions.GRAPH, dense)
    ctx = {"trace": _trace()}
    assert MOE.read(ctx) is None
    assert GLUE.read(ctx) == pytest.approx(0.07)


@pytest.mark.parametrize("case", ["no_map", "mismatch", "no_trace",
                                  "no_replay", "no_spans_module"])
def test_readers_silent(case, step_map, monkeypatch):
    ctx = {"trace": _trace()}
    if case == "no_map":
        monkeypatch.delitem(spans._MAPS, regions.GRAPH)
    elif case == "mismatch":
        ctx["trace"] = _trace(drop=(1, 4))
    elif case == "no_trace":
        ctx["trace"] = None
    elif case == "no_replay":
        ctx["trace"] = _trace(replays=0)
    else:
        real = builtins.__import__

        def imp(name, globals=None, locals=None, fromlist=(), level=0):
            if name == "repro_torch" and "spans" in (fromlist or ()):
                raise ImportError("no spans")
            return real(name, globals, locals, fromlist, level)
        monkeypatch.setattr(builtins, "__import__", imp)
    assert GLUE.read(ctx) is None and MOE.read(ctx) is None
