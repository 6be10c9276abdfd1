"""The serving suites (counterpart of ``benchmarks/serving_bench.py``):
ragged closed-loop traffic whole-prompt against chunked, TTFT and prefill
shapes; the block pool's shared-prefix suite; the open-loop suite with its
saturation sweep; overload; and the seeded chaos suite (``run_chaos``).

Each keeps the reference's configs (the smoke llama3.2-1b), traffic, row
names and gates.  Where the reference reads JAX's compile counter, the
port reads its own: graphs that traffic found missing after
``Engine.warmup()`` (``warmup_report()["post_warmup_misses"]``), whose
contract is 0, under that name.  Whole-prompt admission compiles nothing
per prompt length in PyTorch; its ``prefill_shapes`` is still the number
of distinct prompt lengths (one prefill shape each), as the reference
counts it, against the chunked engine's measured bucket count.

The suites and ``run_chaos`` take ``params`` (the smoke model's weights;
``run_chaos`` seeds them on ``device`` when none are given) so that a
caller can bring its own, and the open-loop and overload suites a
``clock`` for the Engine (default: real time).  ``run`` seeds its own, as
the reference's does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import configs
from ..core.policy import QuantPolicy
from ..data import SyntheticCorpus
from ..device import resolve_device
from ..models import transformer as T
from ..serving import (ChaosEvent, Engine, FaultInjector, FinishReason,
                       MetricsRecorder, Request, TickClock, WorkloadSpec,
                       find_saturation, poisson_trace, run_open_loop)
from . import common as C

ARCH = "llama3p2_1b"


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _smoke_model(device, params=None):
    cfg = configs.get_smoke(ARCH)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    return cfg, params


def _policy(cfg, bits_v: float = 1.5):
    return QuantPolicy(bits_k=2.0, bits_v=bits_v,
                       group_size=min(16, cfg.head_dim), window=16, n_sink=4)


def _serve(params, cfg, pol, reqs, max_len, prefill_chunk, device=None):
    """One closed-loop wave on 2 slots, whole-prompt or chunked."""
    eng = Engine(params, cfg, pol, batch_slots=2, max_len=max_len,
                 steps_per_sync=4, prefill_chunk=prefill_chunk,
                 device=device)
    t0 = time.time()
    handles = [eng.submit(Request(prompt=r.prompt, max_new=r.max_new,
                                  seed=r.seed)) for r in reqs]
    eng.run(handles)
    wall = time.time() - t0
    toks = sum(len(h.tokens) for h in handles)
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]
    if prefill_chunk:
        shapes = len(eng.prefill_shapes)
    else:
        shapes = len({len(r.prompt) for r in reqs})  # one shape per length
    # per-request final occupancy (live tokens / per-slot capacity): the
    # regime block pruning targets
    occ = [(len(h.request.prompt) + len(h.tokens)) / max_len for h in handles]
    return {"wall_s": wall, "tok_s": toks / max(wall, 1e-9),
            "ttft_p50_ms": _pct(ttft, 50), "ttft_max_ms": max(ttft),
            "prefill_shapes": shapes,
            "occ_mean": float(np.mean(occ)), "occ_max": float(np.max(occ)),
            "backend_info": eng.backend_info,
            "streams": [h.result().tolist() for h in handles]}


def _serve_pool(params, cfg, pol, reqs, max_len, pool_blocks, bt, slots,
                device=None):
    """Serve a wave through the paged block pool (DESIGN.md §9), stepping
    manually so peak occupancy and admitted concurrency are sampled live."""
    eng = Engine(params, cfg, pol, batch_slots=slots, max_len=max_len,
                 steps_per_sync=4, pool_blocks=pool_blocks,
                 pool_block_tokens=bt, device=device)
    t0 = time.time()
    handles = [eng.submit(Request(prompt=r.prompt, max_new=r.max_new,
                                  seed=r.seed)) for r in reqs]
    concurrency = 0
    while any(not h.finished for h in handles):
        if not eng.step():
            break
        concurrency = max(concurrency, eng.active_slots)
    wall = time.time() - t0
    st = eng.stats()
    toks = sum(len(h.tokens) for h in handles)
    return {"wall_s": wall, "tok_s": toks / max(wall, 1e-9),
            "streams": [h.result().tolist() for h in handles],
            "concurrency": concurrency, "stats": st}


def _gate(gates: dict) -> str:
    return "pass" if all(gates.values()) else "FAIL"


def _shared_prefix_suite(emit, params, cfg, smoke, device=None):
    """Content-addressed prefix sharing under the block pool: N requests
    with an identical long prefix must quantize it ONCE, share the blocks
    copy-on-write, and keep fewer packed bytes resident than per-slot
    stripes would.  Gated: a hit rate > 0, copy-on-write copies > 0, and
    resident bytes under half the striped worst case."""
    pol = _policy(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(7)
    bt, max_len, slots = 8, 84, 3          # packed = 64 tokens = 8 blocks
    n_req = 3 if smoke else 6
    prefix = corpus.sample(72, np.random.default_rng(100))
    reqs = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size, size=6).astype(prefix.dtype)
        reqs.append(Request(prompt=np.concatenate([prefix, tail]),
                            max_new=6, seed=i))

    pooled = _serve_pool(params, cfg, pol, reqs, max_len,
                         pool_blocks=4 * 8, bt=bt, slots=slots, device=device)
    # striped baseline: the same wave through per-slot stripes
    eng = Engine(params, cfg, pol, batch_slots=slots, max_len=max_len,
                 steps_per_sync=4, device=device)
    handles = [eng.submit(Request(prompt=r.prompt, max_new=r.max_new,
                                  seed=r.seed)) for r in reqs]
    t0 = time.time()
    eng.run(handles)
    wall = time.time() - t0
    striped_streams = [h.result().tolist() for h in handles]
    if pooled["streams"] != striped_streams:
        raise RuntimeError("pooled streams diverged from striped baseline")

    st = pooled["stats"]
    ratio = st["peak_resident_bytes"] / max(st["striped_worst_case_bytes"], 1)
    emit(f"serve_shared_prefix_pooled,"
         f"{pooled['wall_s'] * 1e6 / len(reqs):.1f},"
         f"mode=closed;offered_rps=unbounded;"
         f"achieved_rps={len(reqs) / max(pooled['wall_s'], 1e-9):.2f};"
         f"resident_peak_bytes={st['peak_resident_bytes']};"
         f"striped_worst_case_bytes={st['striped_worst_case_bytes']};"
         f"resident_ratio={ratio:.3f};"
         f"prefix_hit_rate={st['prefix_hit_rate']:.3f};"
         f"prefix_hits={st['prefix_hits']};"
         f"prefix_misses={st['prefix_misses']};"
         f"cow_copies={st['cow_copies']};"
         f"peak_used_blocks={st['peak_used']};"
         f"admitted_concurrency={pooled['concurrency']};"
         f"tok_s={pooled['tok_s']:.2f}")
    emit(f"serve_shared_prefix_striped,{wall * 1e6 / len(reqs):.1f},"
         f"packed_bytes={st['striped_worst_case_bytes']};"
         f"admitted_concurrency={slots};tok_s="
         f"{sum(len(s) for s in striped_streams) / max(wall, 1e-9):.2f}")
    gates = {"prefix_hit_rate>0": st["prefix_hit_rate"] > 0,
             "cow_copies>0": st["cow_copies"] > 0,
             "resident_ratio<0.5": ratio < 0.5}
    emit(f"serve_pool_summary,0.0,"
         f"pool_blocks={st['pool_blocks']};"
         f"pool_block_tokens={st['pool_block_tokens']};"
         f"resident_ratio={ratio:.3f};"
         f"prefix_hit_rate={st['prefix_hit_rate']:.3f};"
         f"cow_copies={st['cow_copies']};"
         f"gate={_gate(gates)}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(
            f"shared-prefix pool gates failed: {failed} (stats: {st})")
    return pooled


def _open_loop_suite(emit, params, cfg, smoke, device=None, clock=None):
    """Open-loop serving under a Poisson clock (DESIGN.md §10): warm a
    chunked + pooled + async engine, drive a seeded arrival trace, report
    offered against achieved load, TTFT/TPOT percentiles and goodput
    under an SLA, then a saturation sweep on the SAME engine.  Gated: no
    graph missing after warmup over the traffic, every request finished,
    goodput rows present."""
    pol = _policy(cfg, bits_v=2.0)
    bt, max_len, slots = 16, 148, 3        # packed = 128 tokens = 8 blocks
    eng = Engine(params, cfg, pol, batch_slots=slots, max_len=max_len,
                 steps_per_sync=4, prefill_chunk=16,
                 pool_blocks=64, pool_block_tokens=bt, async_host=True,
                 clock=clock, device=device)
    rep = eng.warmup()
    emit(f"serve_warmup,{rep['capture_s'] * 1e6:.1f},"
         f"n_graphs={rep['n_graphs']};"
         f"capture_s={rep['capture_s']:.2f};"
         f"build_s={rep['build_s']:.2f};"
         f"rehearse_s={rep['rehearse_s']:.2f}")

    sla_ttft_ms, sla_tpot_ms = 2000.0, 500.0
    spec = WorkloadSpec(n_requests=8 if smoke else 24, arrival_rate=8.0,
                        prompt_lens=(24, 40, 56), max_news=(6, 10),
                        shared_prefix_ratio=0.5, shared_prefix_len=12,
                        vocab=cfg.vocab_size, seed=0)
    rec = MetricsRecorder()
    handles, _ = run_open_loop(eng, poisson_trace(spec), rec)
    post = eng.warmup_report()["post_warmup_misses"]
    summ = rec.summary(sla_ttft_ms=sla_ttft_ms, sla_tpot_ms=sla_tpot_ms)
    good = summ["goodput"]
    gates = {"no_graph_miss": post == 0,
             "all_finished": summ["n_finished"] == summ["n_requests"],
             "goodput_rows": summ["n_requests"] > 0
             and good["goodput_rps"] >= 0.0}
    emit(f"serve_open_loop,{summ['makespan_s'] * 1e6:.1f},"
         f"mode=open;"
         f"offered_rps={summ['offered_rps']:.2f};"
         f"achieved_rps={summ['achieved_rps']:.2f};"
         f"achieved_tok_s={summ['achieved_tok_s']:.2f};"
         f"n_requests={summ['n_requests']};"
         f"n_finished={summ['n_finished']};"
         f"ttft_p50_ms={summ['ttft_ms']['p50']:.0f};"
         f"ttft_p90_ms={summ['ttft_ms']['p90']:.0f};"
         f"ttft_p99_ms={summ['ttft_ms']['p99']:.0f};"
         f"tpot_p50_ms={summ['tpot_ms']['p50']:.1f};"
         f"tpot_p90_ms={summ['tpot_ms']['p90']:.1f};"
         f"tpot_p99_ms={summ['tpot_ms']['p99']:.1f};"
         f"queue_wait_p90_ms={summ['queue_wait_ms']['p90']:.0f};"
         f"queue_depth_max={summ.get('queue_depth_max', 0)};"
         f"pool_used_max={summ.get('pool_used_max', 0)};"
         f"sla_ttft_ms={sla_ttft_ms:.0f};sla_tpot_ms={sla_tpot_ms:.0f};"
         f"sla_attainment={good['attainment']:.3f};"
         f"goodput_rps={good['goodput_rps']:.2f};"
         f"goodput_tok_s={good['goodput_tok_s']:.2f};"
         f"post_warmup_misses={post};"
         f"gate={_gate(gates)}")

    # saturation sweep: same engine, ascending offered load, the last rate
    # whose SLA attainment still clears the target
    rates = (4.0, 12.0) if smoke else (4.0, 8.0, 16.0, 32.0)

    def eval_at_rate(rate):
        s = dataclasses.replace(spec, arrival_rate=rate,
                                seed=int(round(rate * 1000)))
        r = MetricsRecorder()
        run_open_loop(eng, poisson_trace(s), r)
        return r.summary(sla_ttft_ms=sla_ttft_ms, sla_tpot_ms=sla_tpot_ms)

    sat = find_saturation(eval_at_rate, rates, attainment_target=0.9)
    table = ";".join(
        f"rate{row['rate']:.0f}_att={row['attainment']:.3f}"
        for row in sat["table"])
    sat_rps = sat["saturation_rps"]
    post = eng.warmup_report()["post_warmup_misses"]
    emit(f"serve_saturation,0.0,"
         f"mode=open;attainment_target={sat['attainment_target']:.2f};"
         f"saturation_rps={'none' if sat_rps is None else f'{sat_rps:.1f}'};"
         f"{table};post_warmup_misses={post}")
    eng.close()
    gates["no_graph_miss"] = gates["no_graph_miss"] and post == 0
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(
            f"open-loop serving gates failed: {failed} "
            f"(post_warmup_misses={post}, summary={summ})")
    return {"handles": handles, "summary": summ, "saturation": sat,
            "gates": gates}


def _overload_suite(emit, params, cfg, smoke, device=None, clock=None):
    """Graceful degradation under overload (DESIGN.md §11): offered load
    well past saturation, a priority mix, and a block pool at ~50% of the
    wave's working set, so admission must stall, preempt and spill.
    Gated: the run terminates, every request carries a terminal
    FinishReason, goodput stays positive, the pool/spill audit is clean,
    and no graph is missing after warmup."""
    pol = _policy(cfg)
    # 40-token prompts + <=12 new + 4-step sync margin - (sink+window) = 36
    # packed tokens -> 5 blocks eventual demand per request; 2 slots x 5 =
    # 10 working-set blocks, pool_blocks=5 puts the pool at 50% of that
    bt, max_len, slots = 8, 84, 2
    eng = Engine(params, cfg, pol, batch_slots=slots, max_len=max_len,
                 steps_per_sync=4, prefill_chunk=8,
                 pool_blocks=5, pool_block_tokens=bt, async_host=True,
                 host_spill_bytes=4 << 20, clock=clock, device=device)
    rep = eng.warmup()
    spec = WorkloadSpec(n_requests=6 if smoke else 14, arrival_rate=100.0,
                        prompt_lens=(40,), max_news=(8, 12),
                        shared_prefix_ratio=0.5, shared_prefix_len=16,
                        vocab=cfg.vocab_size, priorities=(0, 1), seed=11)
    rec = MetricsRecorder()
    handles, makespan = run_open_loop(eng, poisson_trace(spec), rec)
    summ = rec.summary(sla_ttft_ms=120_000.0, sla_tpot_ms=None)
    st = eng.stats()
    c = st["counters"]
    try:
        eng.check_invariants()
        leak_ok = True
    except RuntimeError:
        leak_ok = False
    post = eng.warmup_report()["post_warmup_misses"]
    gates = {
        "all_terminal": all(
            h.finished and h.finish_reason in FinishReason.TERMINAL
            for h in handles),
        "goodput>0": summ["goodput"]["goodput_rps"] > 0,
        "no_block_leak": leak_ok,
        "no_graph_miss": rep["post_warmup_misses"] == 0 and post == 0,
    }
    emit(f"serve_overload,{makespan * 1e6 / len(handles):.1f},"
         f"mode=open;offered_rps={summ['offered_rps']:.1f};"
         f"achieved_rps={summ['achieved_rps']:.2f};"
         f"n_requests={summ['n_requests']};"
         f"n_finished={summ['n_finished']};"
         f"finish_reasons={summ['finish_reasons']};"
         f"pool_blocks=5;working_set_blocks=10;"
         f"preemptions={c['preemptions']};"
         f"pool_stalls={c['pool_exhausted_stalls']};"
         f"spilled_blocks={c['spilled_blocks']};"
         f"restored_blocks={c['restored_blocks']};"
         f"goodput_rps={summ['goodput']['goodput_rps']:.2f};"
         f"post_warmup_misses={post};"
         f"gate={_gate(gates)}")
    eng.close()
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise RuntimeError(
            f"overload gates failed: {failed} "
            f"(reasons={summ['finish_reasons']}, counters={c})")
    return {"handles": handles, "counters": c, "gates": gates}


def run_chaos(emit, smoke: bool = False, device=None, params=None):
    """Seeded chaos (DESIGN.md §11): pooled engines through pool-exhaustion
    and NaN-logit fault traces under a TickClock.  Gated: every stream
    ends with a terminal FinishReason (no hang), the pool/spill audit
    finds no leaked block, no graph is missing after warmup, and the
    faults fired."""
    dev = resolve_device(device)
    cfg, params = _smoke_model(dev, params)
    pol = _policy(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    bt, max_len, slots = 8, 84, 2
    n_req = 5 if smoke else 10
    rng = np.random.default_rng(3)

    def wave():
        return [Request(prompt=corpus.sample(40, np.random.default_rng(i)),
                        max_new=int(rng.integers(6, 11)), seed=i,
                        priority=i % 2)
                for i in range(n_req)]

    scenarios = {
        # exhaustion bursts seize 60% of free blocks for 6 ticks, twice
        "pool": [ChaosEvent(tick=t, kind="pool", duration=6, magnitude=0.6)
                 for t in (3, 14)],
        # two NaN-poisoned decode chunks -> slot quarantine, others clean
        "nan": [ChaosEvent(tick=t, kind="nan") for t in (4, 12)],
    }
    out = {}
    for name, events in scenarios.items():
        inj = FaultInjector(events)
        eng = Engine(params, cfg, pol, batch_slots=slots, max_len=max_len,
                     steps_per_sync=4, prefill_chunk=8,
                     pool_blocks=12, pool_block_tokens=bt, async_host=True,
                     host_spill_bytes=4 << 20, clock=TickClock(0.01),
                     faults=inj, device=dev)
        rep = eng.warmup()
        t0 = time.time()
        handles = [eng.submit(r) for r in wave()]
        ticks = 0
        while eng.step():
            ticks += 1
            if ticks > 5000:
                raise RuntimeError(f"chaos '{name}': engine still busy "
                                   f"after {ticks} ticks — hung stream")
        eng.drain()
        wall = time.time() - t0
        st = eng.stats()
        c = st["counters"]
        try:
            eng.check_invariants()
            leak_ok = True
        except RuntimeError:
            leak_ok = False
        post = eng.warmup_report()["post_warmup_misses"]
        gates = {
            "all_terminal": all(
                h.finished and h.finish_reason in FinishReason.TERMINAL
                for h in handles),
            "no_block_leak": leak_ok,
            "no_graph_miss": rep["post_warmup_misses"] == 0 and post == 0,
            "faults_fired": sum(inj.stats()["injected"].values()) > 0,
        }
        reasons = {}
        for h in handles:
            reasons[h.finish_reason] = reasons.get(h.finish_reason, 0) + 1
        emit(f"serve_chaos_{name},{wall * 1e6 / len(handles):.1f},"
             f"mode=closed;n_requests={len(handles)};"
             f"finish_reasons={reasons};"
             f"injected={inj.stats()['injected']};"
             f"preemptions={c['preemptions']};"
             f"pool_stalls={c['pool_exhausted_stalls']};"
             f"nan_quarantines={c['nan_quarantines']};"
             f"spilled_blocks={c['spilled_blocks']};"
             f"restored_blocks={c['restored_blocks']};"
             f"post_warmup_misses={post};"
             f"gate={_gate(gates)}")
        eng.close()
        out[name] = {"reasons": reasons, "counters": c, "gates": gates,
                     "streams": [h.result().tolist() for h in handles]}
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise RuntimeError(
                f"chaos '{name}' gates failed: {failed} "
                f"(reasons={reasons}, injected={inj.stats()['injected']}, "
                f"counters={c})")
    return out


def ragged_requests(cfg, smoke: bool):
    """The closed-loop wave: >= 6 distinct prompt lengths, the ragged
    regime whole-prompt admission pays one prefill shape each for."""
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    lens = [24, 41, 57, 33, 62, 49] if smoke else [24, 41, 57, 33, 62, 49,
                                                   70, 91, 108, 77]
    return [Request(prompt=corpus.sample(n, np.random.default_rng(i)),
                    max_new=int(rng.integers(4, 9)), seed=i)
            for i, n in enumerate(lens)]


def run(emit, smoke: bool = False, device=None):
    """The ragged closed loop whole-prompt and chunked, then the
    shared-prefix, open-loop and overload suites, on the seeded smoke
    model."""
    dev = resolve_device(device)
    cfg, params = _smoke_model(dev)
    pol = _policy(cfg)
    reqs = ragged_requests(cfg, smoke)
    max_len = max(len(r.prompt) for r in reqs) + 16
    chunk = 16

    whole = _serve(params, cfg, pol, reqs, max_len, None, dev)
    chunked = _serve(params, cfg, pol, reqs, max_len, chunk, dev)

    for name, r in (("serve_ragged_whole_prompt", whole),
                    (f"serve_ragged_chunked_c{chunk}", chunked)):
        # mode=closed: every request is submitted up front, so the offered
        # load is unbounded and only the achieved rate is meaningful
        emit(f"{name},{r['wall_s'] * 1e6 / max(len(reqs), 1):.1f},"
             f"mode=closed;offered_rps=unbounded;"
             f"achieved_rps={len(reqs) / max(r['wall_s'], 1e-9):.2f};"
             f"occupancy_mean={r['occ_mean']:.2f};"
             f"occupancy_max={r['occ_max']:.2f};"
             f"ttft_p50_ms={r['ttft_p50_ms']:.0f};"
             f"ttft_max_ms={r['ttft_max_ms']:.0f};"
             f"tok_s={r['tok_s']:.2f};"
             f"prefill_shapes={r['prefill_shapes']}")
    emit(f"serve_prefill_shape_ratio,0.0,"
         f"whole={whole['prefill_shapes']};chunked={chunked['prefill_shapes']}"
         f";bound=len(chunk_buckets)")
    # per-layer tuples would leak commas into the row
    info = {k: v for k, v in whole["backend_info"].items()
            if not isinstance(v, tuple)}
    emit("serve_backend_info,0.0," +
         ";".join(f"{k}={v}" for k, v in sorted(info.items())))

    _shared_prefix_suite(emit, params, cfg, smoke, dev)
    _open_loop_suite(emit, params, cfg, smoke, dev)
    _overload_suite(emit, params, cfg, smoke, dev)
    return {"whole": whole, "chunked": chunked}
