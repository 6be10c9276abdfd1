"""The port's degradation ladder and fault model (DESIGN.md §11) held to
the JAX package on the CPU, case for case with tests/test_degradation.py:

  (a) priority preemption with a bit-identical resume (equal priority never
      preempts), (b) a seeded chaos trace replayed twice, (c) the host spill
      tier (restore instead of re-insert, LRU under a byte budget), (d)
      deadlines and cancellation, queued and running, (e) NaN quarantine,
      the watchdog and a host-loop consumer crash, (f) one stall count per
      stalled tick in both admission modes, (g) a clean audit and a valid
      FinishReason for every stream after every scenario.

Each scenario runs on the JAX Engine (``backend="reference"``, and
``"pallas"`` in interpret mode where the reference test uses it) and on the
port's Engine (``backend="cuda"``: the kernels' plain versions on the CPU)
with params converted by ``convert.py``, the same prompts, requests,
``TickClock`` and chaos events.  Tolerance: none — FinishReasons, token
streams, the §11 counters, the tier's stats, chaos events, loadgen traces,
error messages and the CLI's degradation summary compare EXACTLY.

One known deviation of the reference is allowed for (ROADMAP.md §3): its
chunked, pooled Engine does not mark the block tables dirty when a chunked
job activates its slot, so until some other table change the slot's
device row stays masked to the null block and its first decode chunks
read no packed tokens.  The port marks them; the JAX side
here is the reference Engine with that one flag set after activation.
"""
import re
import time as real_time
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import repro.core.block_pool as jbp
import repro.serving as jsv
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.config import ArchConfig as JArch
from repro.models import transformer as JT
from repro.serving import loadgen as jload

import repro_torch.core.block_pool as tbp
import repro_torch.serving as tsv
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.config import ArchConfig
from repro_torch.serving import loadgen as tload

from _torch_degradation import (  # noqa: F401
    SHAPE, KW, JCFG, TCFG, MAX_LEN, BT, COUNTERS, BACKENDS, params, _JEngine,
    _sides, _defaults, _prompt, _drive, _summary, _both)
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)


def test_reference_chunked_pool_leaves_the_activated_row_masked(params):
    """The deviation itself: the reference's chunked, pooled streams
    differ from its whole-prompt ones and from the flushed variant's,
    which equal the port's."""
    jp, tp = params

    def run(mk, sv, **kw):
        eng = mk(**_defaults(kw))
        hs = [eng.submit(sv.Request(prompt=_prompt(i, 14), max_new=12,
                                    seed=i)) for i in range(2)]
        eng.run(hs)
        return [h.tokens for h in hs]
    jmk = lambda cls: (lambda **kw: cls(jp, JCFG, JPolicy(**KW),
                                        backend="reference", **kw))
    raw = run(jmk(jsv.Engine), jsv)
    whole = run(jmk(jsv.Engine), jsv, prefill_chunk=None)
    fixed = run(jmk(_JEngine), jsv)
    port = run(lambda **kw: tsv.Engine(tp, TCFG, QuantPolicy(**KW),
                                       backend="cuda", device="cpu", **kw),
               tsv)
    assert raw != whole and fixed == whole == port


# ------------------------------------------------------ taxonomy & trace

def test_finish_reason_taxonomy():
    J, P = jsv.FinishReason, tsv.FinishReason
    for name in ("OK", "EOS", "LENGTH", "DEADLINE", "CANCELLED", "PREEMPTED",
                 "SHED", "TERMINAL"):
        assert getattr(P, name) == getattr(J, name), name
    for r in ("ok", "eos", "length", "deadline", "cancelled", "shed",
              "preempted-requeued", None, "exploded"):
        assert P.valid(r) == J.valid(r), r
    assert not P.valid(P.PREEMPTED)


SPECS = [dict(n_events=8, kinds=("pool", "nan"), horizon_ticks=40, seed=3),
         dict(n_events=8, kinds=("pool", "nan"), horizon_ticks=40, seed=4),
         dict(n_events=5, kinds=("pool", "nan"), horizon_ticks=16,
              duration=3, magnitude=0.6, seed=5),
         dict(n_events=12, horizon_ticks=64, seed=0),
         dict(n_events=6, kinds=("pool", "nan", "crash"), horizon_ticks=24,
              seed=0)]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_trace_equals_the_reference(spec):
    want = jsv.chaos_trace(jsv.ChaosSpec(**spec))
    got = tsv.chaos_trace(tsv.ChaosSpec(**spec))
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got == tsv.chaos_trace(tsv.ChaosSpec(**spec))


@pytest.mark.parametrize("make", [
    lambda sv: sv.ChaosEvent(tick=1, kind="meteor"),
    lambda sv: sv.ChaosEvent(tick=0, kind="pool"),
    lambda sv: sv.ChaosEvent(tick=1, kind="pool", duration=0),
    lambda sv: sv.ChaosEvent(tick=1, kind="pool", magnitude=0.0),
    lambda sv: sv.ChaosSpec(kinds=("pool", "asteroid")),
    lambda sv: sv.ChaosSpec(kinds=()),
    lambda sv: sv.ChaosSpec(n_events=0),
    lambda sv: sv.ChaosSpec(horizon_ticks=0),
    lambda sv: sv.TickClock(dt_s=0.0)])
def test_chaos_validation_messages_equal(make):
    with pytest.raises(ValueError) as want:
        make(jsv)
    with pytest.raises(ValueError) as got:
        make(tsv)
    assert str(got.value) == str(want.value)


def test_tick_clock():
    for sv in (jsv, tsv):
        clk = sv.TickClock(dt_s=0.5)
        assert clk() == 0.0
        clk.tick(); clk.tick()
        assert clk() == 1.0


class _TimeSpy:
    """Stand-in for the ``time`` module that records every *call* made
    through it (attribute reads alone don't count)."""

    def __init__(self, real, calls):
        self._real, self._calls = real, calls

    def __getattr__(self, name):
        real_attr = getattr(self._real, name)
        if not callable(real_attr):
            return real_attr

        def wrapped(*a, **k):
            self._calls.append(name)
            return real_attr(*a, **k)
        return wrapped


def test_tick_clock_engine_zero_wall_clock_reads(params, monkeypatch):
    """With a TickClock injected, a full submit -> prefill -> decode ->
    finish run of the port's Engine (async host loop included) reads no
    wall clock in engine/host_loop/warmup: every mark comes from the one
    injected clock (DESIGN.md §11)."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import host_loop as host_loop_mod
    from repro_torch.serving import warmup as warmup_mod
    calls = []
    for mod in (engine_mod, host_loop_mod, warmup_mod):
        monkeypatch.setattr(mod, "time", _TimeSpy(real_time, calls))
    _, port = _sides(params)
    clk = tsv.TickClock(dt_s=0.01)
    eng = port.mk(clock=clk, async_host=True)
    hs = [eng.submit(tsv.Request(prompt=_prompt(s, 12), max_new=4))
          for s in (0, 1)]
    while eng.step():
        clk.tick()
    eng.drain()
    assert all(h.finished for h in hs)
    assert calls == [], f"wall-clock reads: {sorted(set(calls))}"
    for h in hs:
        assert 0.0 <= h.submit_time <= h.finish_time <= clk()
    eng.close()


# --------------------------------------------------- spill tier & audits

def _tier_ops(mod):
    tier = mod.HostSpillTier(budget_bytes=100)
    a = {"k": np.zeros(10, np.uint8)}
    out = [tier.put("a", a, 40), tier.put("b", dict(a), 40),
           tier.get("a") is not None, tier.put("c", dict(a), 40),
           tier.stats(), tier.get("b") is None, "c" in tier, len(tier),
           tier.put("huge", dict(a), 101), tier.stats(),
           tier.pop("a") is not None, tier.get("a") is None, tier.stats()]
    tier.check_invariants()
    tier.bytes += 1                          # byte drift must be caught
    with pytest.raises(RuntimeError, match="drift") as e:
        tier.check_invariants()
    out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        mod.HostSpillTier(0)
    out.append(str(e.value))
    return out


def test_host_spill_tier_equals_the_reference():
    got, want = _tier_ops(tbp), _tier_ops(jbp)
    assert got == want
    assert want[4]["entries"] == 2 and want[4]["evicted"] == 1
    assert want[9]["rejected"] == 1 and want[12]["restored"] == 1


def _seize_ops(mod):
    pool = mod.BlockPool(n_blocks=8, n_slots=2, n_table=6, block_nbytes=64)
    out = [pool.check_invariants()]
    held = pool.seize(3)
    out += [held, pool.stats(), pool.check_invariants()]
    pool.release_seized(held[:1])
    out += [pool.stats(), pool.check_invariants(), pool.seize(20),
            pool.stats()]
    pool.release_seized()
    out += [pool.check_invariants()]
    with pytest.raises(ValueError) as e:
        pool.release_seized([3])
    out.append(str(e.value))
    phys = pool.alloc(0)
    pool._free.append(phys)                  # double-free corruption
    with pytest.raises(RuntimeError):
        pool.check_invariants()
    return out


def test_block_pool_audit_and_seize_equal_the_reference():
    assert _seize_ops(tbp) == _seize_ops(jbp)


# ------------------------------------------------- (f) stall accounting

@pytest.mark.parametrize("chunked", [True, False])
def test_pool_stall_counts_once_per_tick(params, chunked):
    """One stalled tick counts one pool_exhausted_stalls in both admission
    modes, tick for tick as the reference counts them."""
    def scenario(side):
        eng = side.mk(pool_blocks=5, prefill_chunk=8 if chunked else None)
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 21), max_new=16,
                                         seed=i)) for i in (0, 1)]
        stalls, n = [], 0
        while eng.step():
            n += 1
            assert n < 800
            stalls.append(eng.stats()["counters"]["pool_exhausted_stalls"])
        out = _summary(eng, hs)
        eng.close()
        return dict(out, stalls=stalls)

    got = _both(params, scenario)
    deltas = np.diff([0] + got["stalls"])
    assert max(got["stalls"]) >= 1 and set(deltas.tolist()) <= {0, 1}
    assert got["reasons"] == ["length", "length"]
    assert got["counters"]["preemptions"] == 0


# ------------------------------------------- (a) preemption + bit replay

def _preempt_serve(side, pool_blocks, submit_hi_late, temperature=0.0,
                   async_host=False):
    R = side.sv.Request
    eng = side.mk(pool_blocks=pool_blocks, host_spill_bytes=1 << 20,
                  clock=side.sv.TickClock(0.01), async_host=async_host)
    lo = eng.submit(R(prompt=_prompt(0, 21), max_new=16, seed=0,
                      priority=0, temperature=temperature))
    hi, n = None, 0
    while True:
        worked = eng.step()
        n += 1
        assert n < 800, "hung"
        if hi is None and (not submit_hi_late
                           or lo._sched_consumed >= 3 or len(lo.tokens) >= 3):
            hi = eng.submit(R(prompt=_prompt(9, 21), max_new=16, seed=9,
                              priority=5, temperature=temperature))
        if not worked and hi is not None:
            break
    eng.drain()
    out = _summary(eng, [lo, hi])
    eng.close()
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_preemption_resume_bit_identical(params, backend):
    """A priority-5 arrival preempts the running priority-0 slot; the
    victim requeues, restores its spilled blocks and resumes: streams,
    events and counters equal the reference's, and the streams equal an
    uninterrupted run."""
    got = _both(params, lambda s: _preempt_serve(s, 5, True), backend)
    c = got["counters"]
    assert c["preemptions"] >= 1 and got["preempted"][0] >= 1
    assert "preempted-requeued" in got["events"][0]
    assert c["restored_blocks"] >= 1
    assert got["reasons"] == ["length", "length"]
    base = _both(params, lambda s: _preempt_serve(s, 24, False), backend)
    assert base["counters"]["preemptions"] == 0
    assert got["streams"] == base["streams"]


def test_preemption_resume_async_host(params):
    """The same preemption through the async host loop: the replay filter
    runs on the consumer thread; streams equal the synchronous run's."""
    _, port = _sides(params)
    sync = _preempt_serve(port, 5, True)
    asy = _preempt_serve(port, 5, True, async_host=True)
    assert asy["counters"]["preemptions"] >= 1
    assert asy["streams"] == sync["streams"]
    assert asy["reasons"] == sync["reasons"] == ["length", "length"]


def test_sampled_preempted_stream_equals_uninterrupted(params):
    """Temperature > 0: a resumed request gets a fresh generator from the
    engine and request seeds and redraws the rows it drew before, so its
    replay is bit-identical and its stream equals the uninterrupted one
    (the port's own sampler; the reference's is jax.random's)."""
    _, port = _sides(params)
    got = _preempt_serve(port, 5, True, temperature=0.9)
    base = _preempt_serve(port, 24, False, temperature=0.9)
    assert got["counters"]["preemptions"] >= 1
    assert base["counters"]["preemptions"] == 0
    assert got["streams"] == base["streams"]
    greedy = _preempt_serve(port, 24, False)
    assert got["streams"] != greedy["streams"]      # sampling really ran


def test_equal_priority_never_preempts(params):
    def scenario(side):
        R = side.sv.Request
        eng = side.mk(pool_blocks=5, host_spill_bytes=1 << 20,
                      clock=side.sv.TickClock(0.01))
        a = eng.submit(R(prompt=_prompt(0, 21), max_new=16, seed=0,
                         priority=3))
        b, n = None, 0
        while True:
            worked = eng.step()
            n += 1
            assert n < 800
            if b is None and len(a.tokens) >= 3:
                b = eng.submit(R(prompt=_prompt(9, 21), max_new=16, seed=9,
                                 priority=3))
            if not worked and b is not None:
                break
        out = _summary(eng, [a, b])
        eng.close()
        return out

    got = _both(params, scenario)
    assert got["counters"]["preemptions"] == 0
    assert got["preempted"] == [0, 0] and got["reasons"] == ["length"] * 2


# --------------------------------------------- (b) chaos determinism

@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_trace_replay_is_deterministic(params, backend):
    """The same seeded chaos trace, twice on the port: identical results,
    equal to the reference's run of the same trace."""
    spec = dict(n_events=5, kinds=("pool", "nan"), horizon_ticks=16,
                duration=3, magnitude=0.6, seed=5)

    def scenario(side):
        events = side.sv.chaos_trace(side.sv.ChaosSpec(**spec))
        inj = side.sv.FaultInjector(events)
        eng = side.mk(pool_blocks=10, host_spill_bytes=1 << 20,
                      clock=side.sv.TickClock(0.01), faults=inj)
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 14), max_new=8,
                                         seed=i, priority=i % 2))
              for i in range(4)]
        _drive(eng)
        out = _summary(eng, hs)
        eng.close()
        return dict(out, injected=inj.stats())

    got = _both(params, scenario, backend)
    _, port = _sides(params, backend)
    assert scenario(port) == got, "chaos replay diverged"
    assert got["counters"]["nan_quarantines"] == \
        got["injected"]["injected"]["nan"]
