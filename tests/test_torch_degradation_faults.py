"""The port's degradation ladder and fault model (DESIGN.md §11) held to
the JAX package on the CPU, second half (the first is
``test_torch_degradation.py``, whose docstring says how the engines are
compared; the split lets ``--dist loadfile`` run the halves on two
workers): (c) the host spill tier, (d) deadlines and cancellation, (e)
NaN quarantine, the watchdog and a host-loop consumer crash, the
overload acceptance run, loadgen and the two CLIs' degradation
summaries.  Tolerance: none, as there."""
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
