"""The port's regions and the map of a captured step (``repro_torch.spans``)
on the CPU:

* outside a recorded capture and without the profiler a region does
  nothing: it opens no span and records no map, and an eager
  ``decode_one`` is BITWISE the one with every region a null context;
* under the CPU profiler an eager ``decode_one`` of a smoke dense and a
  smoke MoE model opens every region's span: each attention region once
  a layer inside that layer's span, the MoE regions on MoE layers only;
* a map recorded against an injected operation counter: rows in the
  order the regions opened, with their parents in the path; leaves tile
  what they cover in order; operations under no leaf are ``other``; an
  error inside a recording propagates as raised and leaves no map;
* :func:`spans.attribute` on synthetic operation lists: the markers, a
  replay that does not hold the map's count (None), and replays cut by
  the ends of the list left out.

The capture itself (device nodes, markers, a replayed trace) needs the
card: tests/test_torch_cuda.py."""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, spans
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import decode_one
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

POL = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=2)
ARCHS = ["llama3p2_1b", "deepseek_moe_16b"]
ATTN = ("attn.qkv", "attn.append", "attn.kernel", "attn.segment",
        "attn.out")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
       "moe.shared")


def _step(arch):
    """A smoke model after a 21-token prefill of 2 slots on the kernels'
    plain versions, and ``run()``: one eager ``decode_one`` on fresh
    copies of its caches, returning the outputs and the caches."""
    cfg = configs.get_smoke(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=gen)
    _, caches = T.prefill_model(params, cfg, toks, POL, max_len=40,
                                backend="cuda")
    ins = (torch.randint(0, cfg.vocab_size, (2, 1), generator=gen),
           torch.zeros(2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool),
           torch.zeros(2, dtype=torch.int32), torch.zeros(2),
           torch.full((2,), -1))

    def run():
        c = {"scan": {k: v.clone() for k, v in caches["scan"].items()}}
        out = decode_one(params, cfg, POL, ins[0], c, *ins[1:],
                         backend="cuda")
        return out, c
    return cfg, run


def test_region_outside_capture_and_profiler_does_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span opened: {name}")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = spans.op_maps()
    with spans.region("layer.0"):
        with spans.region("attn.qkv"):
            pass
    with spans.span("graph.call:x"):
        pass
    assert spans.op_maps() == before and spans._RECORDER is None


@pytest.mark.parametrize("arch", ARCHS)
def test_eager_step_bitwise_with_null_regions(arch, monkeypatch):
    _, run = _step(arch)
    (got, gc) = run()
    monkeypatch.setattr(spans, "region",
                        lambda name: contextlib.nullcontext())
    (want, wc) = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k in gc["scan"]:
        assert torch.equal(gc["scan"][k], wc["scan"][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_profiled_eager_step_spans_every_region(arch):
    cfg, run = _step(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]

    def inside(lo, hi, name):
        return sum(n == name and lo <= a and b <= hi for n, a, b in ev)
    names = [n for n, _, _ in ev]
    assert names.count("embed") == 1 and names.count("head") == 2
    assert names.count("attn.perm") == 2 * cfg.n_layers + 1  # + the band's
    n_moe = 0
    for i in range(cfg.n_layers):
        (lo, hi), = [(a, b) for n, a, b in ev if n == f"layer.{i}"]
        moe = i >= cfg.first_dense and cfg.n_experts > 0
        n_moe += moe
        for name in ATTN:
            assert inside(lo, hi, name) == 1, (i, name)
        assert inside(lo, hi, "attn.perm") == 2
        assert inside(lo, hi, "attn.mask") == 2
        assert inside(lo, hi, "mlp") == (not moe)
        for name in MOE:
            want = (2 if name in ("moe.route", "moe.combine") else 1) * moe
            assert inside(lo, hi, name) == want, (i, name)
    assert n_moe == (arch == "deepseek_moe_16b") * (cfg.n_layers - 1)


class _CountOps(TorchDispatchMode):
    """Counts every aten call: an injected stand-in for the capture's
    device nodes."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _tiles(op_map):
    """The leaf rows, each starting where the one before it ended or
    later."""
    leaves = op_map.leaves()
    for a, b in zip(leaves, leaves[1:]):
        assert a.first + a.count <= b.first, (a, b)
    return leaves


def test_map_of_synthetic_regions():
    n = [0]

    def ops(k):
        n[0] += k
    ops(5)                                      # before the recording
    with spans.record(lambda: n[0]) as got:
        ops(2)                                  # under no region
        with spans.region("embed"):
            ops(3)
        with spans.region("layer.0"):
            ops(1)                              # under the layer alone
            with spans.region("attn.qkv"):
                ops(4)
            with spans.region("attn.kernel"):
                ops(2)
        with spans.region("head"):
            pass
        with spans.region("head"):
            ops(1)
    m = got.map
    assert m.as_rows() == [["embed", 2, 3], ["layer.0", 5, 7],
                           ["layer.0/attn.qkv", 6, 4],
                           ["layer.0/attn.kernel", 10, 2],
                           ["head", 12, 0], ["head", 12, 1]]
    assert m.total == 13
    assert [r.path for r in _tiles(m)] == [
        "embed", "layer.0/attn.qkv", "layer.0/attn.kernel", "head", "head"]
    o = spans.OTHER
    assert m.owners() == [o, o] + ["embed"] * 3 + [o] + \
        ["layer.0/attn.qkv"] * 4 + ["layer.0/attn.kernel"] * 2 + ["head"]
    assert spans._RECORDER is None


@pytest.mark.parametrize("arch", ARCHS)
def test_map_of_an_eager_step_with_a_counted_dispatch(arch):
    cfg, run = _step(arch)
    with _CountOps() as mode:
        with spans.record(lambda: mode.n) as got:
            run()
    m = got.map
    assert m.total > 0
    for r in m.rows:                             # inside its parent
        if "/" in r.path:
            parent = [p for p in m.rows if p.path == r.path.rsplit("/", 1)[0]
                      and p.first <= r.first
                      and r.first + r.count <= p.first + p.count]
            assert parent, r
    leaves = _tiles(m)
    owners = m.owners()
    assert len(owners) == m.total
    assert sum(r.count for r in leaves) == m.total - owners.count(
        spans.OTHER)
    per_layer = [r.path.split("/", 1)[1] for r in leaves
                 if r.path.startswith("layer.1/")]
    moe = arch == "deepseek_moe_16b"
    assert per_layer == ["attn.qkv", "attn.perm", "attn.append",
                         "attn.mask", "attn.mask", "attn.kernel",
                         "attn.segment", "attn.perm", "attn.out"] + (
        ["moe.route", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine", "moe.shared", "moe.combine"] if moe else ["mlp"])
    tops = [r.path for r in leaves if not r.path.startswith("layer.")]
    assert tops == ["embed", "attn.perm", "attn.mask", "head", "head"]


def _replay(t0, sizes, names=None):
    """One replay's operations from ``t0`` (us): the begin marker, one op
    per entry of ``sizes`` (its duration in us), the end marker."""
    ops, t = [(spans.BEGIN, t0, 1.0)], t0 + 1.0
    for i, d in enumerate(sizes):
        ops.append((names[i] if names else f"k{i}", t, d))
        t += d
    ops.append((spans.END, t, 1.0))
    return ops


MAP = spans.OpMap((spans.Row("embed", 0, 1), spans.Row("layer.0", 1, 3),
                   spans.Row("layer.0/attn.kernel", 2, 2)), 4)


@pytest.mark.parametrize("case", ["whole", "cut_edges", "unsorted",
                                  "short", "long", "none"])
def test_attribute(case):
    a, b = _replay(0.0, [10, 20, 30, 40]), _replay(200.0, [1, 2, 3, 4])
    ops = a + b
    if case == "cut_edges":            # a replay's tail, another's head
        ops = _replay(-100.0, [5, 5, 5, 5])[3:] + ops + \
            _replay(400.0, [7, 7, 7, 7])[:3]
    elif case == "unsorted":
        ops = ops[::-1]
    elif case == "short":
        ops = a + b[:2] + b[3:]
    elif case == "long":
        ops = a + b[:2] + [("extra", 202.5, 0.1)] + b[2:]
    elif case == "none":
        ops = [("k0", 0.0, 1.0)]
    got = spans.attribute(ops, MAP)
    if case in ("short", "long"):
        assert got is None
        return
    if case == "none":
        assert got.replays == 0 and got.seconds == {}
        return
    assert got.replays == 2
    want = {"embed": 11e-6, "other": 22e-6, "layer.0/attn.kernel": 77e-6}
    assert got.seconds.keys() == want.keys()
    for k, v in want.items():
        assert got.seconds[k] == pytest.approx(v, rel=1e-12)
    assert got.by_name() == pytest.approx(
        {"embed": 11e-6, "other": 22e-6, "attn.kernel": 77e-6})


def test_failed_recording_keeps_the_error_and_no_map():
    """An error inside a recorded region propagates as it was raised, even
    where the counter itself would fail on the way out (a capture that
    the error ended), and the recording leaves no map."""
    ended = [False]

    def count():
        if ended[0]:
            raise RuntimeError("the stream is not capturing")
        return 0
    with pytest.raises(ValueError, match="launch failed"):
        with spans.record(count) as rec:
            with spans.region("layer.0"):
                with spans.region("attn.kernel"):
                    ended[0] = True
                    raise ValueError("launch failed")
    assert rec.map is None and spans._RECORDER is None
