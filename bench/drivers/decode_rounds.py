"""Decode rounds: ``slots`` concurrent sessions, each holding a cache of
``context`` tokens, decode greedily in rounds of ``round_tokens``.

Set-up draws the weights, fills every slot's cache through the port's
filler from K/V drawn from the seed (a prefill of that length would take
minutes), snapshots on the device the cache regions a round writes, and
captures the port's ``decode_one`` once with its ``GraphCache``.  The
window replays it ``steps_per_sync`` times, then copies the chunk's
tokens to the host once, as the Engine's decode chunk does; each round
starts from the snapshot, so every round does the same work whatever the
speed.

``decode_tok_s`` is every token the window generated over the window's
seconds.  ``peak_mem_gib`` and the device's peak are the peak allocation
of set-up and window less the snapshot's exact bytes.  Correctness: once
the window has closed and the program's caches are freed, the reference
reruns the first ``check_tokens`` tokens of a seeded round in every slot,
teacher-forced on the tokens served, and the widest and the mean gap by
which a served token's logit lies below the reference's best are
compared with their limits."""
from __future__ import annotations

import numpy as np
import torch

from harness import compare, inputs, program, traffic as gen
from harness.runner import Outcome, free_device_memory
from harness.seeds import sub_seed

GIB = 2 ** 30


def run(r) -> Outcome:
    cfg, tr, dev = r.cfg, r.traffic, r.device
    phases = _Phases(r)
    arch, pol = program.arch_config(cfg), program.policy(cfg)
    ref = r.reference()
    if dev.type == "cuda":
        program.load_kernels()
    phases.mark("kernels")
    dtype = getattr(torch, cfg["dtype"])
    params = inputs.draw_weights(ref.param_specs(cfg), r.seed, dev, dtype)
    phases.mark("weights")
    program.check_params(params, arch)
    b, ctx_len = tr["slots"], tr["context"]
    rt, n = tr["round_tokens"], tr["steps_per_sync"]
    hkv, hd = cfg["num_key_value_heads"], cfg["head_dim"]

    def source(slot, layer):
        return inputs.prefix_kv(r.seed, slot, layer, ctx_len, hkv, hd, dev,
                                dtype)

    caches = program.alloc_caches(arch, pol, b, ctx_len + rt, dev, dtype)
    program.fill(caches, arch, pol, ctx_len, source)
    phases.mark("fill")
    peak_pre = _peak(dev)
    live = program.round_state(caches, pol, ctx_len)
    snap = [t.clone() for t in live]
    snap_bytes = sum(t.numel() * t.element_size() for t in snap)

    def restore():
        for dst, src in zip(live, snap):
            dst.copy_(src)

    step = program.decode_step_fn(params, arch, pol, caches)
    if r.fault is not None:
        step = r.fault(step, caches)
    zeros_b = torch.zeros((b,), dtype=torch.bool, device=dev)
    static = (torch.zeros((b, 1), dtype=torch.int64, device=dev), zeros_b,
              zeros_b.clone(), torch.zeros((b,), dtype=torch.int32,
                                           device=dev),
              torch.zeros((b,), dtype=torch.float32, device=dev),
              torch.full((b,), -1, dtype=torch.int64, device=dev))
    flags = static[1:]
    graphs = program.graph_cache(dev)
    graphs.warm("decode_step", step, static)
    buf = torch.empty((b, n), dtype=torch.int64, device=dev)

    def chunk(token):
        with r.tracer.span("replays"):
            for s in range(n):
                nxt = graphs.call("decode_step", step, token, *flags)[0]
                buf[:, s] = nxt
                token = nxt[:, None]
        with r.tracer.span("host_sync"):
            return buf.to("cpu", copy=True), token

    restore()
    chunk(static[0])                 # first replays: cuBLAS, allocator
    restore()
    per_round = rt // n

    def start(ri):
        return torch.as_tensor(gen.decode_start(r.seed, ri, b,
                                                cfg["vocab_size"]),
                               device=dev)
    trace_from, trace_syncs = tr["trace_from_sync"], tr["trace_syncs"]
    phases.mark("capture")
    r.tracer.warm()
    phases.mark("profiler")
    setup_s = r.setup_done()
    r.log("set-up phases, s: " + phases.line())

    t_start = r.clock()
    rounds, syncs, done, ri, traced = [], 0, False, 0, 0
    sync_s = [t_start]
    while not done:
        with r.tracer.span("round_restore"):
            restore()
        token = start(ri)[:, None]
        got = []
        for c in range(per_round):
            if ri == 0 and c == trace_from - 1:
                r.tracer.start()
            if ri == 0 and c == trace_from:
                r.tracer.open_slice()
            host, token = chunk(token)
            got.append(host)
            syncs += 1
            traced += r.tracer.in_slice
            sync_s.append(r.clock())
            if ri == 0 and c == trace_from + trace_syncs - 1:
                r.tracer.stop()
            if r.clock() - t_start >= r.seconds:
                done = True
                break
        rounds.append(torch.cat(got, dim=1))
        ri += 1
    window_s = r.clock() - t_start
    r.tracer.stop()
    r.log("window: %d rounds, %d syncs, ms a sync: %s" % (
        len(rounds), syncs, [round((b - a) * 1e3, 1)
                             for a, b in zip(sync_s, sync_s[1:])]))
    tokens = syncs * n * b
    # the peak over set-up and window, less the harness's snapshot
    peak = max(peak_pre, _peak(dev) - snap_bytes)
    # the slice holds round 0's syncs from trace_from on, fewer than
    # trace_syncs if the window closed first
    traced_lengths = [[ctx_len + s + 1] * b for s in
                      range(trace_from * n, (trace_from + traced) * n)]
    del graphs, step, caches, live, snap, static, flags, buf
    free_device_memory()

    t_check = r.clock()
    gaps = _check(r, ref, params, rounds, start, source)
    r.log("check: %.1f s" % (r.clock() - t_check))
    r.notes["program"] = compare.stats(gaps)
    return Outcome(
        end_to_end={"decode_tok_s": tokens / window_s,
                    "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        checks=compare.checks(gaps, r.cell.limits),
        attempted=tokens, failed=0, memory_peak_bytes=peak,
        layer_ctx={"traced_lengths": traced_lengths})


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


class _Phases:
    """Seconds of each set-up phase, for the run's notes: ``start`` is
    process start to the driver (imports, the card's context)."""

    def __init__(self, r):
        self.r, self.t = r, r.clock()
        self.got = [("start", self.t - r.t0)]

    def mark(self, name: str) -> None:
        if self.r.device.type == "cuda":
            torch.cuda.synchronize(self.r.device)
        now = self.r.clock()
        self.got.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return ", ".join("%s %.2f" % kv for kv in self.got)


def _check(r, ref, params, rounds, start, source) -> torch.Tensor:
    """The reference over the first ``check_tokens`` tokens of every slot
    in a seeded round that has them, teacher-forced on the tokens served:
    each served token's gap below the reference's best."""
    cfg, tr = r.cfg, r.traffic
    k = tr["check_tokens"]
    whole = [i for i, x in enumerate(rounds) if x.shape[1] >= k]
    if not whole:
        raise RuntimeError(f"the window served no round of {k} tokens")
    rng = np.random.default_rng(sub_seed(r.seed, "check"))
    ri = int(rng.choice(whole))
    served = rounds[ri][:, :k].to(r.device)              # (B, k)
    first = start(ri)[:, None]
    fed = torch.cat([first, served[:, :-1]], dim=1)
    p0 = tr["context"]
    kw = dict(p0=p0, qstart=p0, prefix=source)
    with torch.no_grad():
        logits = ref.forward(params, cfg, fed, **kw)
        if r.control:
            low = ref.forward(params, cfg, fed, lower=True, **kw)
            r.notes["control"] = compare.stats(ref.control_gaps(logits, low))
    r.notes["check"] = {"round": ri, "served": int(served.numel())}
    return ref.gaps(logits, served).flatten().cpu()
