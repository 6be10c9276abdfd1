"""The port's serving harness (DESIGN.md §10) held to the JAX package on
the CPU: the open-loop trace and the SLA accounting on the same inputs,
greedy streams of a warmed port Engine against the unwarmed one and the
JAX Engine (whole-prompt, ``backend="reference"``) on the same converted
params, the async host loop against the synchronous one, the host loop's
drain/close/backpressure/crash-retry contracts, the graph cache's
post-warmup miss counter, warmup's restoration of the caches and
counters, the capture-safe ``rope_table``, and the two CLIs' shared
default policy.

Tolerances: traces, token streams, cache bytes, counters and CLI lines
compare EXACTLY; the SLA numbers are float64 arithmetic on identical
inputs by identical expressions and compare exactly too.  On the CPU the
graph cache captures nothing: a warmed engine runs the same per-step
replay loop with the step run eagerly, so these tests cover its control
flow and bookkeeping, and tests/test_torch_cuda.py covers the replay.
"""
import re
import threading
import time

import numpy as np
import pytest
import torch

import jax

from repro.core.policy import QuantPolicy as JPolicy
from repro.models.config import ArchConfig as JArch
from repro.models import transformer as JT
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import loadgen as jload
from repro.serving import metrics as jmet

from repro_torch.core.policy import QuantPolicy
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serving import (Engine, HostLoop, HostLoopCrash,
                                 MetricsRecorder, Request, TokenDelivery,
                                 loadgen as tload, metrics as tmet)
from test_torch_util import stall_until_backpressure
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
# packed region 44 - 12 = 32 tokens = 4 pool blocks of 8
MAX_LEN, POOL_BT, POOL_BLOCKS = 44, 8, 24


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _traffic():
    r = np.random.default_rng(7)
    lens, news = [12, 20, 12, 7, 30], [9, 4, 13, 6, 5]
    return [(r.integers(0, 64, n).astype(np.int32), m)
            for n, m in zip(lens, news)]


def _port(tp, pool=None, warm=False, **kw):
    eng = Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=2, max_len=MAX_LEN,
                 backend=kw.pop("backend", "cuda"), steps_per_sync=4,
                 pool_blocks=pool, pool_block_tokens=POOL_BT, device="cpu",
                 **kw)
    if warm:
        eng.warmup()
    return eng


def _serve(eng, reqs):
    hs = [eng.submit(Request(prompt=r.prompt, max_new=r.max_new, seed=r.seed,
                             temperature=r.temperature, eos_id=r.eos_id))
          for r in reqs]
    eng.run(hs)
    eng.close()
    assert eng.active_slots == 0 and eng.queue_depth == 0
    return [(h.tokens, h.finish_reason) for h in hs]


def _reqs(temps=(0.0,), eos=None):
    return [Request(prompt=p, max_new=m, seed=i,
                    temperature=temps[i % len(temps)], eos_id=eos)
            for i, (p, m) in enumerate(_traffic())]


# ------------------------------------------------- loadgen: the same trace

SPECS = [dict(n_requests=12, arrival_rate=5.0, prompt_lens=(8, 12, 16),
              max_news=(2, 4), vocab=64, seed=7),
         dict(n_requests=32, arrival_rate=10.0, prompt_lens=(12, 16),
              max_news=(2, 5, 3), shared_prefix_ratio=0.5,
              shared_prefix_len=6, temperature=0.7, eos_id=3, vocab=64,
              seed=0),
         dict(n_requests=16, arrival_rate=2.0,
              prompt_lens=(512, 1024, 2048, 3000), max_news=(16, 32, 64),
              shared_prefix_ratio=0.5, shared_prefix_len=256, vocab=32000,
              seed=0)]


@pytest.mark.parametrize("spec", SPECS, ids=["plain", "shared", "chip"])
def test_poisson_trace_byte_equal_to_jax(spec):
    want = jload.poisson_trace(jload.WorkloadSpec(**spec))
    got = tload.poisson_trace(tload.WorkloadSpec(**spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.t == w.t
        assert g.request.prompt.dtype == w.request.prompt.dtype
        assert g.request.prompt.tobytes() == w.request.prompt.tobytes()
        for f in ("max_new", "temperature", "eos_id", "seed"):
            assert getattr(g.request, f) == getattr(w.request, f), f


@pytest.mark.parametrize("bad", [
    dict(arrival_rate=0.0), dict(n_requests=0),
    dict(shared_prefix_ratio=1.5),
    dict(shared_prefix_ratio=0.5, shared_prefix_len=0),
    dict(shared_prefix_ratio=0.5, shared_prefix_len=24,
         prompt_lens=(24, 40)),
    dict(priorities=())])
def test_workload_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as want:
        jload.WorkloadSpec(**bad)
    with pytest.raises(ValueError) as got:
        tload.WorkloadSpec(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [dict(deadline_ms=0.0),
                                 dict(deadline_ms=-100.0)])
def test_workload_spec_rejects_unported_degradation_knobs(bad):
    """The degradation knobs (DESIGN.md §11) are ported: a bad deadline is
    refused with the reference's message, and valid knobs are taken."""
    with pytest.raises(ValueError) as want:
        jload.WorkloadSpec(**bad)
    with pytest.raises(ValueError) as got:
        tload.WorkloadSpec(**bad)
    assert str(got.value) == str(want.value)
    spec = tload.WorkloadSpec(deadline_ms=100.0, priorities=(0, 1))
    assert {a.request.priority for a in tload.poisson_trace(spec)} <= {0, 1}


# ------------------------------------------------- metrics: the same numbers

def _records(mod, rng):
    out = []
    for i in range(9):
        arr = float(rng.uniform(0, 2))
        rec = mod.RequestRecord(rid=i, arrival_s=arr,
                                submit_s=arr + float(rng.uniform(0, .01)),
                                prompt_len=12, max_new=8)
        if i != 4:
            rec.admit_s = rec.submit_s + float(rng.uniform(0, .3))
            rec.first_token_s = rec.admit_s + float(rng.uniform(0, .2))
            rec.n_tokens = int(rng.integers(1, 9))
            if i != 7:
                rec.finish_s = rec.first_token_s + float(rng.uniform(0, 1))
                rec.finish_reason = "length"
        out.append(rec)
    return out


def test_sla_accounting_equals_jax():
    jr = _records(jmet, np.random.default_rng(3))
    tr = _records(tmet, np.random.default_rng(3))
    xs = list(np.random.default_rng(4).exponential(size=37))
    assert tmet.percentiles(xs) == jmet.percentiles(xs)
    assert tmet.percentiles([]) == jmet.percentiles([])
    assert tmet.percentiles(xs, (5, 95)) == jmet.percentiles(xs, (5, 95))
    for sla in [(None, None), (300.0, None), (None, 100.0), (250.0, 90.0),
                (1.0, 1.0)]:
        assert [r.meets_sla(*sla) for r in tr] == \
            [r.meets_sla(*sla) for r in jr]
        assert tmet.goodput(tr, 2.5, *sla) == jmet.goodput(jr, 2.5, *sla)
    for f in ("ttft_ms", "tpot_ms", "e2e_ms"):
        assert [getattr(r, f) for r in tr] == [getattr(r, f) for r in jr]

    def evaluator(mod, recs):
        def at(rate):
            k = int(rate)
            sub = recs[:k]
            done = [r for r in sub if r.finish_s is not None]
            return {"goodput": mod.goodput(done, 2.0, 400.0, 120.0),
                    "ttft_ms": mod.percentiles([r.ttft_ms for r in done]),
                    "tpot_ms": mod.percentiles([r.tpot_ms for r in done
                                                if r.tpot_ms is not None])}
        return at

    rates = [2.0, 3.0, 5.0, 8.0, 9.0]
    for target in (0.5, 0.9):
        assert (tmet.find_saturation(evaluator(tmet, tr), rates, target)
                == jmet.find_saturation(evaluator(jmet, jr), rates, target))


def test_metrics_recorder_samples_the_port_engine(params):
    _, tp = params
    eng = _port(tp, pool=POOL_BLOCKS, async_host=True)
    rec = MetricsRecorder()
    rec.start(eng.now())
    for p, m in _traffic()[:3]:
        h = eng.submit(Request(prompt=p, max_new=m))
        rec.on_submit(h, 0.0, 0.0)
    while eng.step():
        rec.on_step(eng, 0.0)
    eng.drain()
    rec.finalize()
    s = rec.summary(sla_ttft_ms=1e6, sla_tpot_ms=1e6)
    assert s["n_finished"] == 3 and s["goodput"]["attainment"] == 1.0
    assert s["pool_used_max"] > 0 and "host_queue_depth_max" in s
    eng.close()


# ------------------------------------- streams: warmed == unwarmed == JAX

def _run_jax(jp, pool):
    eng = JEngine(jp, JCFG, JPolicy(**KW), batch_slots=2, max_len=MAX_LEN,
                  backend="reference", steps_per_sync=4,
                  pool_blocks=pool, pool_block_tokens=POOL_BT)
    hs = [eng.submit(JRequest(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(_traffic())]
    eng.run(hs)
    return [(list(h.tokens), h.finish_reason) for h in hs]


@pytest.mark.parametrize("pool", [None, POOL_BLOCKS], ids=["striped",
                                                          "pooled"])
def test_warmed_greedy_streams_equal_unwarmed_and_jax(params, pool):
    jp, tp = params
    want = _run_jax(jp, pool)
    assert _serve(_port(tp, pool), _reqs()) == want
    warm = _port(tp, pool, warm=True)
    assert _serve(warm, _reqs()) == want
    assert warm.warmup_report()["post_warmup_misses"] == 0


@pytest.mark.parametrize("pool", [None, POOL_BLOCKS], ids=["striped",
                                                          "pooled"])
def test_warmed_sampled_streams_equal_unwarmed(params, pool):
    _, tp = params
    reqs = _reqs(temps=(0.9, 0.0, 0.6))
    cold = _serve(_port(tp, pool), reqs)
    assert _serve(_port(tp, pool, warm=True), reqs) == cold
    assert cold != _serve(_port(tp, pool), _reqs())


@pytest.mark.parametrize("warm", [False, True], ids=["eager", "warmed"])
@pytest.mark.parametrize("pool", [None, POOL_BLOCKS], ids=["striped",
                                                          "pooled"])
def test_async_streams_equal_sync(params, pool, warm):
    """Mixed temperatures, an EOS id in range and ragged max_new: async
    delivery is pure transport."""
    _, tp = params
    greedy = _serve(_port(tp, pool), _reqs())
    eos = greedy[0][0][2]
    reqs = _reqs(temps=(0.0, 0.7, 0.0, 0.5), eos=eos)
    sync = _serve(_port(tp, pool, warm=warm), reqs)
    asyn = _port(tp, pool, warm=warm, async_host=True)
    assert _serve(asyn, reqs) == sync
    assert "eos" in [r for _, r in sync]
    host = asyn.stats()["host"]
    assert host["delivered"] == sum(len(t) for t, _ in sync)


def test_async_first_token_and_finish_times_come_from_delivery(params):
    _, tp = params
    eng = _port(tp, async_host=True)
    h = eng.submit(Request(prompt=_traffic()[0][0], max_new=3))
    eng.run([h])
    assert h.finished and h.first_token_time is not None
    assert h.submit_time <= h.first_token_time <= h.finish_time
    eng.close()
    assert eng.stats()["host"]["alive"] is False


# --------------------------------------------------- host loop contracts

class _H:
    def __init__(self):
        self.tokens, self.text = [], ""
        self.first_token_time = None


def test_host_loop_drain_and_close():
    """Everything enqueued before close(drain=True) is delivered; a
    second close is a no-op; every item's release runs once."""
    done, released = [], []
    hs = [_H() for _ in range(4)]
    loop = HostLoop(lambda h, reason: done.append((h, reason)),
                    detokenize=lambda toks: "".join(chr(65 + t % 26)
                                                    for t in toks),
                    max_queue=2)
    for i, h in enumerate(hs):
        loop.put(TokenDelivery(handles=[h], rows=[0], counts=[2],
                               reasons=["length" if i % 2 else None],
                               tokens=np.full((1, 2), i, np.int64),
                               release=lambda i=i: released.append(i)))
    loop.close(drain=True)
    st = loop.stats()
    assert st["enqueued"] == 4 and st["delivered"] == 8
    assert st["queue_depth"] == 0 and not st["alive"]
    assert [h.tokens for h in hs] == [[i, i] for i in range(4)]
    assert all(h.text for h in hs)
    assert [r for _, r in done] == ["length", "length"]
    assert released == [0, 1, 2, 3]
    loop.close(drain=True)  # idempotent


def test_engine_close_mid_stream(params):
    """Shutting down with requests still decoding does not deadlock, and
    every delivered token is a prefix of the full sync stream."""
    _, tp = params
    prompt, _ = _traffic()[1]
    ref = _port(tp)
    rh = ref.submit(Request(prompt=prompt, max_new=12))
    ref.run([rh])
    eng = _port(tp, async_host=True)
    h = eng.submit(Request(prompt=prompt, max_new=12))
    eng.step()
    eng.step()
    eng.close(drain=True)
    assert 0 < len(h.tokens) < 12
    assert h.tokens == rh.tokens[:len(h.tokens)]
    eng.close()


def test_host_loop_backpressure_counted():
    """A slow consumer behind a one-item queue makes the producer block;
    the stall is accounted, not silent."""
    release = threading.Event()

    def slow_finish(h, reason):
        release.wait(timeout=5.0)

    def delivery():
        return TokenDelivery(handles=[_H()], rows=[0], counts=[1],
                             reasons=["length"],
                             tokens=np.zeros((1, 1), np.int64))

    loop = HostLoop(slow_finish, max_queue=1)
    t0 = time.time()
    loop.put(delivery())               # consumer takes it, parks in finish
    deadline = time.time() + 5.0
    while loop.queue_depth > 0 and time.time() < deadline:
        time.sleep(0.005)
    loop.put(delivery())               # fills the 1-slot queue
    threading.Timer(0.2, release.set).start()
    loop.put(delivery())               # queue full -> accounted blocking put
    loop.close(drain=True)
    st = loop.stats()
    assert st["delivered"] == 3
    assert st["backpressure_waits"] >= 1 and st["backpressure_s"] > 0
    assert time.time() - t0 < 10


def test_host_loop_crash_retry_keeps_streams_intact(params):
    """HostLoopCrash is contained: the item is retried in place, every
    token arrives exactly once, and the engine finishes normally."""
    _, tp = params
    want = _serve(_port(tp), _reqs())
    eng = _port(tp, async_host=True)
    crashes = iter([1, 0, 0, 1, 1, 0] + [0] * 100)

    def hook(item):
        if next(crashes):
            raise HostLoopCrash("transient")
    eng._host._fault_hook = hook
    assert _serve(eng, _reqs()) == want
    host = eng.stats()["host"]
    assert host["crashes"] == 3 and host["retries"] == 3


def test_host_loop_crash_escalates_after_bounded_retries():
    """A consumer that crashes every attempt escalates to the fatal path
    (re-raised on the caller's thread) instead of retrying forever."""
    released = []

    def hook(item):
        raise HostLoopCrash("always")

    loop = HostLoop(finish_fn=lambda h, r: None, fault_hook=hook)
    loop.put(TokenDelivery(handles=[_H()], rows=[0], counts=[1],
                           reasons=[None], tokens=np.zeros((1, 1), np.int64),
                           release=lambda: released.append(1)))
    with pytest.raises(RuntimeError, match="host loop consumer failed"):
        loop.drain()
    assert loop.crashes == 4 and loop.retries == 3   # 1 try + 3 retries
    assert released == [1]
    loop.close()


def test_async_ring_waits_for_release(params):
    """host_queue=1: a ring of two buffers; a consumer that holds its
    first item until the scheduler has had to wait makes the scheduler
    wait (counted as backpressure) instead of overwriting undelivered
    tokens, and the streams equal the synchronous ones."""
    _, tp = params
    want = _serve(_port(tp), _reqs())
    eng = _port(tp, async_host=True, host_queue=1)
    eng._host._fault_hook = lambda item: stall_until_backpressure(eng)
    assert _serve(eng, _reqs()) == want
    assert len(eng._ring) == 2
    assert eng.stats()["host"]["backpressure_waits"] > 0


# ------------------------------------------------------------ warmup

def test_open_loop_has_no_post_warmup_miss_and_a_new_signature_has_one(
        params):
    _, tp = params
    eng = _port(tp, pool=POOL_BLOCKS, async_host=True)
    rep = eng.warmup()
    assert rep["warmed"] and rep["n_signatures"] == 1
    assert rep["n_graphs"] == 0                 # nothing captured on a CPU
    spec = tload.WorkloadSpec(n_requests=6, arrival_rate=50.0,
                              prompt_lens=(9, 14, 21), max_news=(2, 3, 6),
                              shared_prefix_ratio=0.5, shared_prefix_len=5,
                              vocab=64, seed=3)
    rec = MetricsRecorder()
    handles, _ = tload.run_open_loop(eng, tload.poisson_trace(spec), rec,
                                     time_scale=0.01)
    assert all(h.finished for h in handles)
    assert eng.warmup_report()["post_warmup_misses"] == 0
    assert eng.n_decode_steps > 0
    eng.check_invariants()
    b, v = 3, TCFG.vocab_size
    args = (torch.zeros((b, 1), dtype=torch.int64),
            torch.zeros(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool),
            torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.float32),
            torch.full((b,), -1, dtype=torch.int64),
            torch.zeros((b, v), dtype=torch.float32))
    eng._graphs.call("decode_step", lambda *a: None, *args)
    eng._graphs.call("decode_step", lambda *a: None, *args)
    rep = eng.warmup_report()
    assert rep["post_warmup_misses"] == 1
    assert rep["cold_names"] == ["decode_step"]
    eng.close()


def _widen(caches, batch_slots):
    """Zeroed caches of a prefill's structure with the batch axis (axis 1
    of every layer-stacked leaf) widened to ``batch_slots``."""
    if torch.is_tensor(caches):
        return torch.zeros((caches.shape[0], batch_slots)
                           + tuple(caches.shape[2:]), dtype=caches.dtype)
    return {k: _widen(v, batch_slots) for k, v in caches.items()}


@pytest.mark.parametrize("pool", [None, POOL_BLOCKS], ids=["striped",
                                                          "pooled"])
def test_warmup_leaves_fresh_caches_and_zero_counters(params, pool):
    """The capture's warmup iterations and the rehearsal write the
    engine's own caches: afterwards every leaf equals a fresh allocation
    (the structure first admission allocates) and every counter is 0."""
    _, tp = params
    eng = _port(tp, pool, async_host=True)
    eng.warmup()
    if pool is None:
        _, pre = T.prefill_model(eng.params, TCFG,
                                 torch.zeros((1, 5), dtype=torch.int64),
                                 eng.policy, calib=eng.calib,
                                 max_len=MAX_LEN, backend="cuda")
        fresh = _widen(pre, eng.batch_slots)
    else:
        fresh = eng._alloc_caches()
    got = eng._caches["scan"]
    assert sorted(got) == sorted(fresh["scan"])
    for k, v in fresh["scan"].items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    st = eng.stats()
    assert all(n == 0 for n in st["counters"].values()), st["counters"]
    assert (st["host"]["enqueued"], st["host"]["delivered"]) == (0, 0)
    assert eng.n_decode_steps == 0 and eng._next_rid == 0
    if pool is not None:
        assert st["used"] == 0 and st["peak_used"] == 0
        assert (st["prefix_hits"], st["prefix_misses"]) == (0, 0)
    rep = eng.warmup_report()
    assert rep["rehearse_s"] is not None and rep["build_s"] is not None
    eng.close()


def test_warmup_refuses_traffic_and_restarts_a_served_engine(params):
    """Warmup zeroes the caches it captured on, so it refuses to run
    under traffic; after traffic has drained it starts the engine afresh
    (pool registry included: no stale prefix hit), and streams equal a
    fresh engine's."""
    _, tp = params
    eng = _port(tp, pool=POOL_BLOCKS)
    eng.submit(Request(prompt=_traffic()[0][0], max_new=2))
    with pytest.raises(RuntimeError, match="queued or active"):
        eng.warmup()
    eng.run()
    rep = eng.warmup(prompt_lens=(7, 12))
    assert rep["prefill_s"] is not None
    st = eng.stats()
    assert st["used"] == 0 and st["prefix_misses"] == 0
    assert _serve(eng, _reqs()) == _serve(_port(tp, pool=POOL_BLOCKS),
                                          _reqs())


def test_stats_count_admissions_and_queue_wait_ticks(params):
    _, tp = params
    eng = _port(tp)
    _serve(eng, _reqs())
    c = eng.stats()["counters"]
    assert c["admitted"] == 5
    assert c["queue_wait_ticks"] > 0          # 5 requests on 2 slots
    assert c["pool_exhausted_stalls"] == 0 and c["cow_copies"] == 0


def test_rope_table_bit_identical_to_the_host_tensor_form():
    """The on-device fill gives the same f32 base as the old host tensor,
    so cos/sin are bit-identical."""
    pos = torch.arange(0, 5000, 7, dtype=torch.int32)
    for hd, theta in ((32, 10000.0), (128, 10000.0), (64, 500000.0),
                      (128, 1e6)):
        cos, sin = TL.rope_table(pos, hd, theta)
        half = hd // 2
        idx = torch.arange(0, half, dtype=torch.float32)
        freq = torch.pow(torch.tensor(theta, dtype=torch.float32),
                         -idx / half)
        ang = pos.to(torch.float32)[..., None] * freq
        assert torch.equal(cos.view(torch.int32),
                           torch.cos(ang).view(torch.int32))
        assert torch.equal(sin.view(torch.int32),
                           torch.sin(ang).view(torch.int32))


# ------------------------------------------------------------- the CLIs

LINE = re.compile(r"^arch=(\S+) policy=(\S+) (g\d+) (w\d+) ", re.M)


def test_cli_default_policy_equals_the_reference_cli(capsys):
    """The same arguments and no policy flag give the same policy line in
    both CLIs (the port's defaults were group 128 / window 128, the
    reference's are 64 / 32).  The port alone needs --device cpu here."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--arch", "llama3p2_1b", "--smoke", "--batch", "1",
            "--requests", "1", "--prompt-len", "40", "--new-tokens", "2",
            "--steps-per-sync", "2"]
    jserve.main(args)
    want = LINE.findall(capsys.readouterr().out)
    tserve.main(args + ["--device", "cpu"])
    got = LINE.findall(capsys.readouterr().out)
    assert len(want) == 1 and got == want, (got, want)
