"""Closed-loop serving CLI of the port (subset of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch llama2_7b [--smoke] [--device cpu]

Builds random params from a seed (bf16 on the card, f32 on the CPU), the
paper-style policy from the flags, and serves ``--requests`` requests
(default: two admission waves of ``--batch`` slots) through the port's
:class:`~repro_torch.serving.Engine`, then prints the latency and
time-to-first-token percentiles the reference CLI prints.  Prompts come
from ``SyntheticCorpus(vocab, seed=0)``, request ``i`` sampled with
``np.random.default_rng(i)``, as the reference CLI draws them.  Without
``--device cpu`` it runs on the GPU and raises if there is none.

``--prefill-chunk N`` streams each prompt through the cache in chunks of
at most N tokens (DESIGN.md §7), one chunk per scheduler tick between
decode chunks; 0 prefills whole prompts.

``--policy-schedule first_last_fp16|ladder`` serves a per-layer schedule
(DESIGN.md §8): ``--guard-layers`` fp16 guard layers at each end (clamped
so that one layer stays quantized), or the 4/4 -> base -> base bits ladder
over even thirds of the layers; the CLI prints the schedule's table
(avg-bits and cache bytes per layer band).

``--pool-blocks N`` serves from the paged block pool (DESIGN.md §9) of N
``--pool-block-tokens``-token blocks per quantized band (max_len is
rounded up so the packed region tiles into whole blocks) and prints the
pool summary: prefix hit rate, copy-on-write copies, and peak and
resident packed bytes against the striped worst case.
``--pool-memory-mb`` sizes the pool from a byte budget instead
(DESIGN.md §10).

``--open-loop`` switches to the throughput harness of DESIGN.md §10:
requests arrive on a seeded Poisson clock at ``--arrival-rate`` req/s
regardless of engine progress, ``--warmup`` loads the kernels and
captures the decode step as a CUDA graph before the first arrival (the
run fails if any call misses the graph afterwards), ``--async-host``
moves delivery to the background host loop, and the report becomes
TTFT/TPOT percentiles + goodput under the ``--sla-ttft-ms`` /
``--sla-tpot-ms`` SLA.  The defaults are the reference CLI's.

    python -m repro_torch.launch.serve --arch llama3p2_1b --smoke \
        --device cpu --open-loop --warmup --async-host --arrival-rate 8 \
        --requests 8 --prompt-len 40 --prompt-jitter 16 --new-tokens 12 \
        --pool-blocks 64 --sla-ttft-ms 2000 --sla-tpot-ms 500

Degradation knobs (DESIGN.md §11), as in the reference CLI:
``--deadline-ms`` ends requests that outstay their budget,
``--priority-mix`` assigns priority levels (under pool pressure a
higher-priority request preempts strictly-lower running slots, which
requeue and replay bit-identically), ``--host-spill-mb`` turns on the
host-RAM block spill tier, and ``--chaos {pool,nan,crash,timeout}`` runs a
seeded fault-injection trace (``--chaos-events``, ``--chaos-seed``).
Every run ends with the degradation summary and the invariant audit; a
failed audit exits non-zero:

    python -m repro_torch.launch.serve --arch llama3p2_1b --smoke \
        --device cpu --batch 2 --requests 6 --prompt-len 24 \
        --new-tokens 8 --prefill-chunk 8 --pool-blocks 24 \
        --pool-block-tokens 8 --priority-mix 0,0,1 --host-spill-mb 16 \
        --chaos pool

Every decoder-only family of the port serves here (``--arch hymba_1p5b``
too, the hybrid one, and ``--arch rwkv6_3b``, the attention-free one,
whose caches are its recurrent state: the schedule table and the KV
bytes line still print the SKVQ accounting, as the reference CLI's do).  An encoder-decoder (``--arch
seamless_m4t_large_v2``) exits with the Engine's refusal before any
weight is drawn: its prefill needs encoder frames per request, so it runs
through ``transformer.prefill_model(..., enc_embeds=)`` and
``transformer.decode_step``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import configs
from ..core.kv_cache import schedule_cache_nbytes
from ..core.policy import PolicySchedule, QuantPolicy, as_schedule
from ..core.quant import packed_nbytes
from ..data import SyntheticCorpus
from ..device import resolve_device
from ..kernels import launch_counts
from ..models import transformer as T
from ..serving.engine import check_servable
from ..serving import (ChaosSpec, Engine, FaultInjector, MetricsRecorder,
                       Request, WorkloadSpec, chaos_trace, poisson_trace,
                       run_open_loop)


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _print_schedule_table(schedule, cfg, max_len, dtype):
    """Per-band avg-bits and cache bytes (DESIGN.md §8 accounting): one row
    per contiguous equal-policy band; cache KB is the exact allocation of
    ONE layer of the band at ``max_len`` in the served cache dtype, and the
    total line sums every layer."""
    nbytes = schedule_cache_nbytes(schedule, cfg.n_layers, max_len,
                                   cfg.n_kv_heads, cfg.head_dim, dtype=dtype)
    print("  layers      bits_k  bits_v  window  sinks  avg_bits  "
          "cache_KB/layer")
    for bs, be, p in schedule.bands():
        span = f"{bs}" if be == bs + 1 else f"{bs}-{be - 1}"
        print(f"  {span:<10}  {p.bits_k:<6g}  {p.bits_v:<6g}  {p.window:<6d}"
              f"  {p.n_sink:<5d}  {p.avg_bits(cfg.head_dim):<8.3f}"
              f"  {nbytes[bs] / 1024:.1f}")
    print(f"  schedule avg_bits={schedule.avg_bits(cfg.head_dim):.3f} "
          f"total cache KB/slot={sum(nbytes) / 1024:.1f}")


def _schedule(args, cfg, policy) -> PolicySchedule:
    """The ``--policy-schedule`` preset over ``cfg``'s layers, as the
    reference CLI builds it."""
    if args.policy_schedule == "first_last_fp16":
        # one interior layer must stay quantized (the preset refuses an
        # all-fp16 schedule): clamp for shallow smoke archs
        guard = min(args.guard_layers, max((cfg.n_layers - 1) // 2, 0))
        if guard != args.guard_layers:
            print(f"note: --guard-layers {args.guard_layers} clamped to "
                  f"{guard} ({cfg.n_layers}-layer arch needs 2*guard < "
                  f"layers)")
        return PolicySchedule.first_last_fp16(policy, guard, cfg.n_layers)
    if args.policy_schedule == "ladder":
        return PolicySchedule.bits_ladder(
            policy, ((4.0, 4.0), (args.bits_k, args.bits_v),
                     (args.bits_k, args.bits_v)), cfg.n_layers)
    return as_schedule(policy, cfg.n_layers)


def _priority_mix(args):
    """``--priority-mix`` as the tuple of levels requests cycle through
    (closed loop) or are sampled from (open loop; DESIGN.md §11)."""
    try:
        mix = tuple(int(x) for x in args.priority_mix.split(","))
    except ValueError:
        raise SystemExit(f"--priority-mix must be comma-separated ints, "
                         f"got {args.priority_mix!r}")
    if not mix:
        raise SystemExit("--priority-mix must name at least one level")
    return mix


def _chaos_injector(args, horizon_ticks=64):
    """The seeded :class:`FaultInjector` of ``--chaos`` (DESIGN.md §11),
    or None when chaos is off."""
    if args.chaos == "none":
        return None
    spec = ChaosSpec(n_events=args.chaos_events, kinds=(args.chaos,),
                     horizon_ticks=horizon_ticks, seed=args.chaos_seed)
    events = chaos_trace(spec)
    print(f"chaos: {len(events)} '{args.chaos}' events at ticks "
          f"{[e.tick for e in events]} (seed {args.chaos_seed})")
    return FaultInjector(events)


def _degradation_summary(eng, inj=None):
    """The degradation ladder's report and the invariant audit (DESIGN.md
    §11): preempted, shed, deadline-missed and cancelled requests, blocks
    spilled and restored, NaN quarantines, watchdog trips, the injector's
    accounting when chaos is on; a failed audit exits non-zero."""
    st = eng.stats()
    c = st["counters"]
    print("degradation summary (DESIGN.md §11):")
    print(f"  preempted={c['preemptions']} shed={c['shed']} "
          f"deadline_misses={c['deadline_misses']} "
          f"cancelled={c['cancelled']} "
          f"nan_quarantines={c['nan_quarantines']} "
          f"watchdog_trips={c['watchdog_trips']} "
          f"pool_stalls={c['pool_exhausted_stalls']}")
    if "host_spill" in st:
        t = st["host_spill"]
        print(f"  host spill: {c['spilled_blocks']} spilled / "
              f"{c['restored_blocks']} restored "
              f"({t['bytes']}/{t['budget_bytes']} B resident, "
              f"{t['evicted']} LRU-evicted, {t['rejected']} rejected)")
    if inj is not None:
        s = inj.stats()
        print(f"  chaos: {s['injected']} injected, {s['skipped']} skipped, "
              f"{s['active_holds']} holds outstanding")
    try:
        eng.check_invariants()
        print("  invariant audit: PASS (no leaked blocks)")
    except RuntimeError as e:
        eng.close(drain=False)
        print(f"FAIL: invariant audit: {e}", file=sys.stderr)
        raise SystemExit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: 2x batch — two waves)")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--prompt-jitter", type=int, default=0,
                    help="prompt length drawn from prompt-len ± jitter")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="base max_new per request")
    ap.add_argument("--max-new-jitter", type=int, default=0,
                    help="max_new drawn from new-tokens ± jitter")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop generation at this token id")
    ap.add_argument("--bits-k", type=float, default=2.0)
    ap.add_argument("--bits-v", type=float, default=1.5)
    ap.add_argument("--group-size", type=int, default=64)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--sinks", type=int, default=5)
    ap.add_argument("--policy-schedule", default="uniform",
                    choices=("uniform", "first_last_fp16", "ladder"),
                    help="per-layer policy schedule preset (DESIGN.md §8): "
                         "uniform = every layer runs the --bits-* policy; "
                         "first_last_fp16 = --guard-layers fp16 guard layers "
                         "at each end; ladder = 4/4 -> base -> base bits "
                         "over even layer thirds")
    ap.add_argument("--guard-layers", type=int, default=2,
                    help="fp16 guard layers per end (first_last_fp16 preset)")
    ap.add_argument("--backend", default=None,
                    help="cuda | reference (default: cuda on a card)")
    ap.add_argument("--steps-per-sync", type=int, default=8,
                    help="decode tokens per host sync")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (DESIGN.md §7): stream prompts "
                         "through the cache in chunks of at most this many "
                         "tokens, one chunk per scheduler tick (0 = "
                         "whole-prompt prefill)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged KV block pool of this many blocks "
                         "(DESIGN.md §9); 0 serves striped")
    ap.add_argument("--pool-block-tokens", type=int, default=16,
                    help="tokens per pool block (>= 8)")
    ap.add_argument("--pool-memory-mb", type=float, default=0,
                    help="size the block pool from a device-memory budget "
                         "instead of --pool-blocks (DESIGN.md §10)")
    ap.add_argument("--warmup", action="store_true",
                    help="load the kernels and capture the decode step as "
                         "a CUDA graph before traffic (DESIGN.md §10); with "
                         "--open-loop the run fails if a call misses it")
    ap.add_argument("--async-host", action="store_true",
                    help="deliver tokens on the background host loop "
                         "(DESIGN.md §10) instead of the scheduler thread")
    ap.add_argument("--open-loop", action="store_true",
                    help="open-loop load: Poisson arrivals at "
                         "--arrival-rate req/s, SLA goodput report "
                         "(DESIGN.md §10)")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="open-loop offered load, requests/second")
    ap.add_argument("--shared-prefix-ratio", type=float, default=0.0,
                    help="fraction of open-loop prompts sharing one common "
                         "prefix (exercises pool prefix sharing)")
    ap.add_argument("--sla-ttft-ms", type=float, default=None,
                    help="TTFT SLA bound for the goodput report, ms")
    ap.add_argument("--sla-tpot-ms", type=float, default=None,
                    help="TPOT SLA bound for the goodput report, ms")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (DESIGN.md §11): a request "
                         "still queued or running this many ms after submit "
                         "finishes 'deadline' and frees its blocks")
    ap.add_argument("--priority-mix", default="0",
                    help="comma-separated priority levels assigned to "
                         "requests (DESIGN.md §11); under pool pressure a "
                         "higher-priority request preempts strictly-lower-"
                         "priority running slots (e.g. '0,0,1')")
    ap.add_argument("--host-spill-mb", type=float, default=0,
                    help="host-RAM spill tier byte budget (DESIGN.md §11): "
                         "cold pool blocks spill to host arrays and restore "
                         "on demand (0 = off; needs the pool)")
    ap.add_argument("--chaos", default="none",
                    choices=("none", "pool", "nan", "crash", "timeout"),
                    help="seeded fault injection (DESIGN.md §11): pool "
                         "exhaustion bursts, NaN-logit quarantine, host-"
                         "loop consumer crashes, or simulated device-step "
                         "timeouts")
    ap.add_argument("--chaos-events", type=int, default=4,
                    help="number of chaos events to schedule")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="chaos trace seed (same seed, same fault ticks)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    is_fp16 = args.bits_k >= 16 and args.bits_v >= 16
    policy = QuantPolicy(bits_k=args.bits_k, bits_v=args.bits_v,
                         group_size=min(args.group_size, cfg.head_dim),
                         window=0 if is_fp16 else args.window,
                         n_sink=0 if is_fp16 else args.sinks)
    schedule = _schedule(args, cfg, policy)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = T.init_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    n_req = args.requests or 2 * args.batch
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(args.seed)
    jit = args.max_new_jitter
    mix = _priority_mix(args)
    reqs = []
    for i in range(n_req):
        max_new = max(1, args.new_tokens + (int(rng.integers(-jit, jit + 1))
                                            if jit else 0))
        plen = args.prompt_len
        if args.prompt_jitter:
            plen = max(1, plen + int(rng.integers(-args.prompt_jitter,
                                                  args.prompt_jitter + 1)))
        prompt = corpus.sample(plen, np.random.default_rng(i))
        reqs.append(Request(prompt=prompt, max_new=max_new,
                            temperature=args.temperature, eos_id=args.eos_id,
                            deadline_ms=args.deadline_ms,
                            priority=mix[i % len(mix)], seed=i))
    max_len = (args.prompt_len + args.prompt_jitter + args.new_tokens + jit
               + args.steps_per_sync)
    pooled = bool(args.pool_blocks or args.pool_memory_mb)
    if pooled:
        # round max_len up so every quantized band's packed region
        # (max_len - n_sink - window) tiles into whole pool blocks
        bt = args.pool_block_tokens
        for _ in range(bt):
            if all(p.is_fp16 or (max_len - p.n_sink - p.window) % bt == 0
                   for p in schedule.distinct()):
                break
            max_len += 1
    inj = _chaos_injector(args)
    eng = Engine(params, cfg, schedule, batch_slots=args.batch,
                 max_len=max_len,
                 backend=args.backend, steps_per_sync=args.steps_per_sync,
                 prefill_chunk=args.prefill_chunk or None,
                 pool_blocks=args.pool_blocks or None,
                 pool_block_tokens=args.pool_block_tokens,
                 pool_memory_bytes=int(args.pool_memory_mb * 2 ** 20) or None,
                 host_spill_bytes=int(args.host_spill_mb * 2 ** 20) or None,
                 async_host=args.async_host, faults=inj, device=dev)
    if args.warmup:
        rep = eng.warmup()
        print(f"warmup: {rep['n_graphs']} CUDA graph(s) captured in "
              f"{rep['capture_s']:.2f}s, kernels loaded in "
              f"{rep['build_s']:.2f}s, rehearsal {rep['rehearse_s']:.2f}s")
    if args.open_loop:
        return _open_loop(eng, args, cfg, n_req, policy, inj)
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    total = sum(len(h.tokens) for h in handles)
    lat = [(h.finish_time - h.submit_time) * 1e3 for h in handles
           if h.finish_time is not None]
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles
            if h.first_token_time is not None]
    fp16_b = 2 * cfg.head_dim * 2
    q_b = (packed_nbytes(cfg.head_dim, policy.bits_k, policy.group_size,
                         policy.meta_dtype_bits)
           + packed_nbytes(cfg.head_dim, policy.bits_v, policy.group_size,
                           policy.meta_dtype_bits))
    print(f"arch={cfg.name} policy=K{args.bits_k}V{args.bits_v} "
          f"g{policy.group_size} w{policy.window} slots={args.batch} "
          f"requests={n_req} device={dev} "
          f"schedule={args.policy_schedule}")
    _print_schedule_table(schedule, cfg, max_len, dtype)
    info = eng.backend_info
    print(f"backend: name={info['name']} kernels={info['kernels']} "
          f"launches={launch_counts()}")
    reasons = {}
    for h in handles:
        reasons[h.finish_reason] = reasons.get(h.finish_reason, 0) + 1
    print(f"finish reasons: {reasons}")
    print(f"served {n_req} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s aggregate)")
    print(f"latency ms/request: p50={_pct(lat, 50):.0f} "
          f"p90={_pct(lat, 90):.0f} p99={_pct(lat, 99):.0f} "
          f"max={max(lat, default=0):.0f}")
    print(f"time-to-first-token ms: p50={_pct(ttft, 50):.0f} "
          f"p90={_pct(ttft, 90):.0f} p99={_pct(ttft, 99):.0f} "
          f"max={max(ttft, default=0):.0f}")
    if args.prefill_chunk:
        print(f"chunked prefill: chunk={args.prefill_chunk} "
              f"buckets={eng.chunk_buckets} buckets run="
              f"{eng.prefill_shapes}")
    if pooled:
        st = eng.stats()
        print(f"pool: {st['pool_blocks']} blocks x "
              f"{st['pool_block_tokens']} tok, peak used {st['peak_used']} "
              f"({st['peak_resident_bytes']} B packed vs "
              f"{st['striped_worst_case_bytes']} B striped worst case), "
              f"resident now {st['resident_bytes']} B, prefix hit rate "
              f"{st['prefix_hit_rate']:.2f} ({st['prefix_hits']} hits / "
              f"{st['prefix_misses']} misses), cow copies "
              f"{st['cow_copies']}, stalls "
              f"{st['counters']['pool_exhausted_stalls']}")
    print(f"KV bytes/token-head: fp16={fp16_b}  skvq={q_b} "
          f"({fp16_b / q_b:.1f}x compression)")
    if handles[0].tokens:
        print("sample:", handles[0].tokens[:16])
    _degradation_summary(eng, inj)
    eng.close()
    return handles


def _open_loop(eng, args, cfg, n_req, policy, inj=None):
    """Open-loop serving run + SLA goodput report (DESIGN.md §10): a
    seeded Poisson trace from the CLI's prompt/max-new knobs, driven on
    the wall clock; prints offered vs achieved load, TTFT/TPOT/e2e
    percentiles, gauges, counters and goodput under the ``--sla-*``
    bounds.  With ``--warmup`` it exits non-zero if any call missed the
    captured graph afterwards."""
    print(f"arch={cfg.name} policy=K{args.bits_k}V{args.bits_v} "
          f"g{policy.group_size} w{policy.window} slots={args.batch} "
          f"requests={n_req} device={eng.device} open-loop")
    plens = sorted({max(1, args.prompt_len + d) for d in
                    (-args.prompt_jitter, 0, args.prompt_jitter)})
    mnews = sorted({max(1, args.new_tokens + d) for d in
                    (-args.max_new_jitter, 0, args.max_new_jitter)})
    spec = WorkloadSpec(
        n_requests=n_req, arrival_rate=args.arrival_rate,
        prompt_lens=plens, max_news=mnews, temperature=args.temperature,
        eos_id=args.eos_id, shared_prefix_ratio=args.shared_prefix_ratio,
        shared_prefix_len=min(plens) // 2 if args.shared_prefix_ratio else 0,
        vocab=cfg.vocab_size, deadline_ms=args.deadline_ms,
        priorities=_priority_mix(args), seed=args.seed)
    rec = MetricsRecorder()
    handles, makespan = run_open_loop(eng, poisson_trace(spec), rec)
    s = rec.summary(sla_ttft_ms=args.sla_ttft_ms,
                    sla_tpot_ms=args.sla_tpot_ms)
    print(f"open loop: {s['n_finished']}/{s['n_requests']} requests in "
          f"{makespan:.2f}s — offered {s['offered_rps']:.2f} req/s, "
          f"achieved {s['achieved_rps']:.2f} req/s "
          f"({s['achieved_tok_s']:.1f} tok/s)")
    for name in ("ttft_ms", "tpot_ms", "e2e_ms", "queue_wait_ms"):
        p = s[name]
        print(f"  {name:<14} p50={p['p50']:.1f} p90={p['p90']:.1f} "
              f"p99={p['p99']:.1f}")
    print(f"  gauges: queue max={s.get('queue_depth_max', 0)} "
          f"host-queue max={s.get('host_queue_depth_max', 0)} "
          f"slots max={s.get('active_slots_max', 0)}"
          + (f" pool-used max={s['pool_used_max']}"
             if "pool_used_max" in s else ""))
    st = eng.stats()
    print(f"  counters: {st['counters']}")
    if eng.prefill_chunk:
        print(f"  chunked prefill: chunk={eng.prefill_chunk} "
              f"buckets={eng.chunk_buckets} buckets run="
              f"{eng.prefill_shapes}")
    if "host" in st:
        print(f"  host loop: {st['host']}")
    if "goodput" in s:
        g = s["goodput"]
        print(f"  goodput @ SLA(ttft<={g['sla_ttft_ms']}ms, "
              f"tpot<={g['sla_tpot_ms']}ms): {g['n_ok']}/{s['n_finished']} "
              f"ok ({100 * g['attainment']:.0f}%), "
              f"{g['goodput_rps']:.2f} req/s, {g['goodput_tok_s']:.1f} tok/s")
    print(f"  finish reasons: {s.get('finish_reasons', {})}")
    _degradation_summary(eng, inj)
    if args.warmup:
        rep = eng.warmup_report()
        if rep["post_warmup_misses"]:
            eng.close()
            raise SystemExit(f"FAIL: {rep['post_warmup_misses']} call(s) "
                             f"missed the captured graph after warmup "
                             f"({rep['cold_names']})")
        print(f"  zero post-warmup graph misses; {rep['replays']} replays")
    eng.close()
    return handles


if __name__ == "__main__":
    main()
