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

SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
# packed region: max_len 44 - (window 8 + sink 4) = 32 tokens = 4 x 8
MAX_LEN, BT = 44, 8
COUNTERS = ("preemptions", "spilled_blocks", "restored_blocks",
            "deadline_misses", "cancelled", "shed", "nan_quarantines",
            "watchdog_trips", "pool_exhausted_stalls")
BACKENDS = ["reference", "pallas"]


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


class _JEngine(jsv.Engine):
    """The reference Engine with its activated chunked job's table row
    flushed (the deviation of the module docstring)."""

    def _finish_prefill(self, job, logits):
        super()._finish_prefill(job, logits)
        for pool in self._pools.values():
            pool.dirty = True


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


def _sides(params, backend="reference"):
    """The two engines' factories and their modules, side by side."""
    jp, tp = params

    def jmk(**kw):
        return _JEngine(jp, JCFG, JPolicy(**KW), backend=backend,
                        **_defaults(kw))

    def tmk(**kw):
        return tsv.Engine(tp, TCFG, QuantPolicy(**KW), backend="cuda",
                          device="cpu", **_defaults(kw))
    return (SimpleNamespace(name="jax", mk=jmk, sv=jsv),
            SimpleNamespace(name="port", mk=tmk, sv=tsv))


def _defaults(kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("steps_per_sync", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("pool_blocks", 24)
    kw.setdefault("pool_block_tokens", BT)
    return kw


def _prompt(seed, n):
    return np.asarray(np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], (n,)), np.int32)


def _drive(eng, cap=800):
    n = 0
    while eng.step():
        n += 1
        assert n < cap, "engine still busy — hung stream / deadlock"
    eng.drain()


def _summary(eng, handles):
    """What must agree between the engines, after the audit passed."""
    audit = eng.check_invariants()
    st = eng.stats()
    c = st["counters"]
    for h in handles:
        assert h.finished and tsv.FinishReason.valid(h.finish_reason)
    return {"streams": [list(h.tokens) for h in handles],
            "reasons": [h.finish_reason for h in handles],
            "preempted": [h.preempted for h in handles],
            "events": [list(h.events) for h in handles],
            "counters": {k: c[k] for k in COUNTERS},
            "host_spill": st.get("host_spill"),
            "audit": audit}


def _both(params, scenario, backend="reference"):
    """Run ``scenario(side)`` on both engines; assert equal summaries."""
    want, got = (scenario(side) for side in _sides(params, backend))
    assert got == want
    return got


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


# ------------------------------------------------ (c) host spill tier

def test_spill_restore_avoids_requantization(params):
    pref = _prompt(42, 24)

    def serve(side, spill):
        eng = side.mk(batch_slots=1, pool_blocks=8,
                      host_spill_bytes=(1 << 20) if spill else None)
        hs, misses = [], []
        for i in range(2):
            before = sum(p.misses for p in eng._pools.values())
            h = eng.submit(side.sv.Request(prompt=np.concatenate(
                [pref, _prompt(100 + i, 8)]).astype(np.int32), max_new=2,
                seed=i))
            eng.run([h])
            hs.append(h)
            misses.append(sum(p.misses for p in eng._pools.values())
                          - before)
        out = _summary(eng, hs)
        eng.close()
        return dict(out, misses=misses)

    got = _both(params, lambda s: serve(s, True))
    c = got["counters"]
    assert c["restored_blocks"] >= 1 and c["spilled_blocks"] >= 1
    assert got["misses"][1] < got["misses"][0]
    ref = _both(params, lambda s: serve(s, False))
    assert got["streams"] == ref["streams"]
    assert got["misses"][1] < ref["misses"][1]


def test_spill_budget_evicts_lru(params):
    def scenario(side):
        probe = side.mk(batch_slots=1, pool_blocks=8,
                        host_spill_bytes=1 << 20)
        h = probe.submit(side.sv.Request(prompt=_prompt(0, 24), max_new=2,
                                         seed=0))
        probe.run([h])
        st = probe.stats()["host_spill"]
        per_block = st["bytes"] // max(st["entries"], 1)
        probe.close()
        eng = side.mk(batch_slots=1, pool_blocks=8,
                      host_spill_bytes=per_block)
        hs = []
        for i in range(2):
            hs.append(eng.submit(side.sv.Request(prompt=_prompt(i, 24),
                                                 max_new=2, seed=i)))
            eng.run([hs[-1]])
        out = _summary(eng, hs)
        eng.close()
        return dict(out, per_block=per_block)

    got = _both(params, scenario)
    st = got["host_spill"]
    assert st["bytes"] <= got["per_block"] and st["entries"] <= 1
    assert st["evicted"] >= 1


# ------------------------------------- (d) deadlines and cancellation

def test_deadline_expires_running_and_queued(params):
    def scenario(side):
        R = side.sv.Request
        eng = side.mk(clock=side.sv.TickClock(dt_s=10.0), batch_slots=1)
        run = eng.submit(R(prompt=_prompt(0, 14), max_new=30, seed=0,
                           deadline_ms=25_000))
        queued = eng.submit(R(prompt=_prompt(1, 14), max_new=4, seed=1,
                              deadline_ms=1.0))
        ok = eng.submit(R(prompt=_prompt(2, 14), max_new=4, seed=2))
        _drive(eng)
        out = _summary(eng, [run, queued, ok])
        eng.close()
        return out

    got = _both(params, scenario)
    assert got["reasons"] == ["deadline", "deadline", "length"]
    assert got["streams"][0] and not got["streams"][1]
    assert got["counters"]["deadline_misses"] == 2


def test_cancel_queued_and_running(params):
    def scenario(side):
        R = side.sv.Request
        eng = side.mk(batch_slots=1)
        a = eng.submit(R(prompt=_prompt(0, 14), max_new=30, seed=0))
        b = eng.submit(R(prompt=_prompt(1, 14), max_new=4, seed=1))
        b.cancel()                            # still queued
        used, n, worked = [], 0, True
        while worked:
            worked = eng.step()
            n += 1
            assert n < 800
            used.append(eng.stats()["used"])
            if len(a.tokens) >= 3 and not a.finished and not a._cancel:
                a.cancel()                    # mid-decode
                used.append("cancel")
        eng.drain()
        out = _summary(eng, [a, b])
        eng.close()
        return dict(out, used=used)

    got = _both(params, scenario)
    assert got["reasons"] == ["cancelled", "cancelled"]
    assert 3 <= len(got["streams"][0]) < 30 and not got["streams"][1]
    assert got["counters"]["cancelled"] == 2
    at = got["used"].index("cancel")
    assert got["used"][at - 1] > 0 and got["used"][at + 1] == 0  # that tick


def test_request_validation_messages_equal(params):
    jside, tside = _sides(params)
    bad = [dict(deadline_ms=0.0), dict(deadline_ms=-3.0),
           dict(priority=1.5)]
    for kw in bad:
        msgs = []
        for side in (jside, tside):
            eng = side.mk()
            with pytest.raises(ValueError) as e:
                eng.submit(side.sv.Request(prompt=_prompt(0, 8), **kw))
            msgs.append(str(e.value))
            eng.close()
        assert msgs[0] == msgs[1], kw
    for kw in (dict(pool_blocks=None, host_spill_bytes=1 << 20),
               dict(step_timeout_s=0.0), dict(watchdog_max_trips=0)):
        msgs = []
        for side in (jside, tside):
            with pytest.raises(ValueError) as e:
                side.mk(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw


# ------------------------------------------- (e) nan / watchdog / crash

@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_quarantine_isolates_slot(params, backend):
    def scenario(side, fault=True):
        eng = side.mk(clock=side.sv.TickClock(0.01), faults=(
            side.sv.FaultInjector([side.sv.ChaosEvent(tick=6, kind="nan")])
            if fault else None))
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 14), max_new=12,
                                         seed=i)) for i in range(2)]
        _drive(eng)
        out = _summary(eng, hs)
        eng.close()
        return out

    got = _both(params, scenario, backend)
    assert got["counters"]["nan_quarantines"] == 1
    assert sorted(got["reasons"]) == ["length", "shed"]
    survivor = got["reasons"].index("length")
    clean = _both(params, lambda s: scenario(s, fault=False), backend)
    assert got["streams"][survivor] == clean["streams"][survivor]


def test_nan_quarantine_async_host(params):
    """The quarantine through the async host loop: the shed slot gets a
    zero-token delivery, the neighbour's stream equals the sync run's."""
    def scenario(side, async_host):
        eng = side.mk(clock=side.sv.TickClock(0.01), async_host=async_host,
                      faults=side.sv.FaultInjector(
                          [side.sv.ChaosEvent(tick=6, kind="nan")]))
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 14), max_new=12,
                                         seed=i)) for i in range(2)]
        _drive(eng)
        out = _summary(eng, hs)
        eng.close()
        return out

    got = _both(params, lambda s: scenario(s, True))
    _, port = _sides(params)
    assert got == scenario(port, False)


def test_watchdog_sheds_all_on_wedged_device(params):
    def scenario(side):
        inj = side.sv.FaultInjector([side.sv.ChaosEvent(
            tick=4, kind="timeout", duration=4, magnitude=99.0)])
        eng = side.mk(clock=side.sv.TickClock(0.01), faults=inj,
                      step_timeout_s=30.0, watchdog_max_trips=2)
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 14), max_new=12,
                                         seed=i)) for i in range(3)]
        _drive(eng)
        out = _summary(eng, hs)
        eng.close()
        return out

    got = _both(params, scenario)
    c = got["counters"]
    assert c["watchdog_trips"] >= 2 and c["shed"] >= 1
    assert "shed" in got["reasons"]


def test_watchdog_single_slow_step_is_noise(params):
    def scenario(side):
        inj = side.sv.FaultInjector([side.sv.ChaosEvent(
            tick=3, kind="timeout", duration=1, magnitude=99.0)])
        eng = side.mk(clock=side.sv.TickClock(0.01), faults=inj,
                      step_timeout_s=30.0, watchdog_max_trips=2)
        h = eng.submit(side.sv.Request(prompt=_prompt(0, 14), max_new=12,
                                       seed=0))
        _drive(eng)
        out = _summary(eng, [h])
        eng.close()
        return out

    got = _both(params, scenario)
    assert got["reasons"] == ["length"]
    assert got["counters"]["watchdog_trips"] == 1
    assert got["counters"]["shed"] == 0


def test_host_loop_crash_retry_keeps_streams_intact(params):
    def scenario(side, fault=True):
        inj = side.sv.FaultInjector([side.sv.ChaosEvent(tick=3, kind="crash"),
                                     side.sv.ChaosEvent(tick=5, kind="crash")])
        eng = side.mk(async_host=fault, clock=side.sv.TickClock(0.01),
                      faults=inj if fault else None)
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 14), max_new=8,
                                         seed=i)) for i in range(3)]
        _drive(eng)
        out = _summary(eng, hs)
        if fault:
            host = eng.stats()["host"]
            out["host"] = (host["crashes"], host["retries"])
        eng.close()
        return out

    got = _both(params, scenario)
    assert got["host"][0] >= 1 and got["host"][1] >= 1
    clean = _both(params, lambda s: scenario(s, fault=False))
    assert got["streams"] == clean["streams"]
    assert got["reasons"] == ["length"] * 3


def test_host_loop_crash_escalates_after_bounded_retries():
    done = []

    def hook(item):
        raise tsv.HostLoopCrash("always")

    loop = tsv.HostLoop(finish_fn=lambda h, r: done.append(r),
                        fault_hook=hook)

    class H:
        tokens, text, first_token_time = [], "", None
    loop.put(tsv.TokenDelivery(handles=[H()], rows=[0], counts=[1],
                               reasons=[None],
                               tokens=np.zeros((1, 1), np.int64)))
    with pytest.raises(RuntimeError, match="host loop consumer failed"):
        loop.drain()
    assert loop.crashes == 4 and loop.retries == 3   # 1 try + 3 retries


def test_zero_token_finish_carries_no_ring_buffer(params):
    """A cancel on an async engine reaches the stream as a zero-token
    delivery: no ring buffer, none released, every buffer free after."""
    _, port = _sides(params)
    eng = port.mk(batch_slots=1, async_host=True)
    a = eng.submit(tsv.Request(prompt=_prompt(0, 14), max_new=30, seed=0))
    b = eng.submit(tsv.Request(prompt=_prompt(1, 14), max_new=4, seed=1))
    b.cancel()
    seen = []
    put = eng._host.put
    eng._host.put = lambda item: (seen.append(item), put(item))[1]
    _drive(eng)
    zero = [it for it in seen if it.counts == [0]]
    assert zero and all(it.release is None for it in zero)
    assert b.finish_reason == "cancelled" and not b.tokens
    assert all(ev.is_set() for ev in eng._ring_free)
    eng.close()
    assert a.finish_reason == "length"


# --------------------------------------------- acceptance: overload run

@pytest.mark.parametrize("backend", BACKENDS)
def test_overload_chaos_acceptance(params, backend):
    def scenario(side, tight):
        events = [side.sv.ChaosEvent(tick=t, kind="pool", duration=4,
                                     magnitude=0.5) for t in (5, 15)]
        eng = side.mk(pool_blocks=5 if tight else 24,
                      host_spill_bytes=1 << 20,
                      clock=side.sv.TickClock(0.01),
                      faults=side.sv.FaultInjector(events) if tight
                      else None)
        hs = [eng.submit(side.sv.Request(prompt=_prompt(i, 21), max_new=8,
                                         seed=i, priority=i % 2))
              for i in range(5)]
        _drive(eng)
        out = _summary(eng, hs)
        eng.close()
        return out

    got = _both(params, lambda s: scenario(s, True), backend)
    assert got["counters"]["pool_exhausted_stalls"] >= 1
    ref = _both(params, lambda s: scenario(s, False), backend)
    assert got["streams"] == ref["streams"]


# ------------------------------------------------ loadgen and the CLIs

@pytest.mark.parametrize("spec", [
    dict(n_requests=12, arrival_rate=5.0, prompt_lens=(8, 12, 16),
         max_news=(2, 4), vocab=64, deadline_ms=250.0, priorities=(0, 0, 1),
         seed=7),
    dict(n_requests=24, arrival_rate=10.0, prompt_lens=(12, 16),
         max_news=(2, 5), shared_prefix_ratio=0.5, shared_prefix_len=6,
         priorities=(0, 1, 2), vocab=64, seed=0),
    dict(n_requests=8, arrival_rate=2.0, prompt_lens=(24,), max_news=(8,),
         deadline_ms=1e4, vocab=64, seed=3)])
def test_poisson_trace_with_degradation_knobs_equals_the_reference(spec):
    want = jload.poisson_trace(jload.WorkloadSpec(**spec))
    got = tload.poisson_trace(tload.WorkloadSpec(**spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.t == w.t
        assert g.request.prompt.tobytes() == w.request.prompt.tobytes()
        for f in ("max_new", "temperature", "eos_id", "seed", "deadline_ms",
                  "priority"):
            assert getattr(g.request, f) == getattr(w.request, f), f


SUMMARY = re.compile(r"^degradation summary.*?invariant audit: \w+",
                     re.M | re.S)


def test_cli_degradation_summary_equals_the_reference_cli(capsys):
    """One ``--chaos pool --priority-mix 0,0,1 --host-spill-mb`` run of
    each CLI: the chaos line and the degradation summary (counters, tier,
    injector, audit) print the same.  Random params differ between the
    packages; the summary depends on the scheduling only."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--arch", "llama3p2_1b", "--smoke", "--batch", "2",
            "--requests", "6", "--prompt-len", "48", "--new-tokens", "8",
            "--prefill-chunk", "8", "--pool-blocks", "10",
            "--pool-block-tokens", "8", "--priority-mix", "0,0,1",
            "--host-spill-mb", "16", "--chaos", "pool", "--chaos-events",
            "6", "--chaos-seed", "1"]
    jserve.main(args)
    want = capsys.readouterr().out
    tserve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    for pat in (SUMMARY, re.compile(r"^chaos: .*$", re.M)):
        w, g = pat.findall(want), pat.findall(got)
        assert len(w) == 1 and g == w, (g, w)
    assert "invariant audit: PASS" in got
    assert "host spill: 6 spilled" in got and "{'pool': 4," in got
