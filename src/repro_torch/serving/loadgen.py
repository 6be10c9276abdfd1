"""Open-loop load generator: seeded Poisson arrivals + wall-clock runner
(port of ``repro.serving.loadgen``; DESIGN.md §10).

Closed-loop benchmarking (submit a batch, run to completion, divide) hides
exactly the failure mode a serving stack exists to manage: requests that
arrive while the engine is busy.  This module generates *open-loop*
traffic — arrival times are drawn from a Poisson process **independent of
the engine's progress**, so queueing delay shows up in TTFT instead of
being silently absorbed by the harness:

* :class:`WorkloadSpec` — the workload knobs (arrival rate, prompt/max-new
  length mixes, temperature, shared-prefix ratio) plus the seed;
* :func:`poisson_trace` — materializes the spec into a deterministic list
  of :class:`Arrival` (same seed → same trace, byte for byte: asserted in
  tests/test_serving_harness.py; the port's trace equals the reference's
  for the same spec, tests/test_torch_harness.py), with a
  ``shared_prefix_ratio`` fraction of prompts opening with one common
  prefix so the block pool's content-addressed sharing sees realistic hit
  traffic;
* :func:`run_open_loop` — the wall-clock runner: submit every arrival
  whose time has come, tick the engine once, repeat; never blocks waiting
  for an arrival while the engine still has work.  Feeds a
  :class:`~repro_torch.serving.metrics.MetricsRecorder` per submit and per
  step.

The degradation knobs of DESIGN.md §11 ride along: every request gets the
spec's ``deadline_ms`` and a priority drawn from ``priorities``, by the
reference's draws, so the traces stay byte-equal.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .engine import Engine, Request, StreamHandle

__all__ = ["WorkloadSpec", "Arrival", "poisson_trace", "run_open_loop"]


@dataclasses.dataclass
class WorkloadSpec:
    """Knobs for one synthetic open-loop workload (DESIGN.md §10).

    ``arrival_rate`` is the offered load in requests/second (Poisson);
    ``prompt_lens``/``max_news`` are mixes sampled uniformly per request;
    ``shared_prefix_ratio`` is the fraction of prompts that start with one
    common ``shared_prefix_len``-token prefix (the pool's prefix-sharing
    traffic knob); ``temperature``/``eos_id`` pass through to each
    :class:`repro_torch.serving.engine.Request`, as do the degradation
    knobs (DESIGN.md §11): every request gets ``deadline_ms`` and a
    priority sampled uniformly from ``priorities``.  Everything is driven
    by ``seed`` — two specs with equal fields produce identical traces.
    """
    n_requests: int = 16
    arrival_rate: float = 4.0
    prompt_lens: Sequence[int] = (24, 40, 56)
    max_news: Sequence[int] = (8, 16)
    temperature: float = 0.0
    eos_id: Optional[int] = None
    shared_prefix_ratio: float = 0.0
    shared_prefix_len: int = 0
    vocab: int = 256
    deadline_ms: Optional[float] = None
    priorities: Sequence[int] = (0,)
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, "
                             f"got {self.n_requests}")
        if self.arrival_rate <= 0:
            raise ValueError(f"arrival_rate must be > 0 req/s, "
                             f"got {self.arrival_rate}")
        if not (0.0 <= self.shared_prefix_ratio <= 1.0):
            raise ValueError(f"shared_prefix_ratio must be in [0, 1], "
                             f"got {self.shared_prefix_ratio}")
        if self.shared_prefix_ratio > 0 and self.shared_prefix_len < 1:
            raise ValueError("shared_prefix_ratio > 0 requires "
                             "shared_prefix_len >= 1")
        if self.shared_prefix_len >= min(self.prompt_lens):
            if self.shared_prefix_ratio > 0:
                raise ValueError(
                    f"shared_prefix_len ({self.shared_prefix_len}) must be "
                    f"shorter than the shortest prompt mix entry "
                    f"({min(self.prompt_lens)})")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {self.deadline_ms}")
        if not self.priorities:
            raise ValueError("priorities must be non-empty")


@dataclasses.dataclass
class Arrival:
    """One scheduled request: submit ``request`` at trace time ``t`` seconds
    (DESIGN.md §10)."""
    t: float
    request: Request


def poisson_trace(spec: WorkloadSpec) -> List[Arrival]:
    """Materialize a :class:`WorkloadSpec` into a deterministic arrival
    trace (DESIGN.md §10).

    Inter-arrival gaps are exponential with mean ``1/arrival_rate``
    (Poisson process); prompt length, max_new, shared-prefix membership and
    prompt tokens all come from one ``np.random.default_rng(seed)`` stream,
    so the trace — times and token ids — is a pure function of the spec.
    """
    rng = np.random.default_rng(spec.seed)
    prefix = rng.integers(0, spec.vocab, size=spec.shared_prefix_len) \
        if spec.shared_prefix_len else np.zeros((0,), np.int64)
    t = 0.0
    out: List[Arrival] = []
    for i in range(spec.n_requests):
        t += float(rng.exponential(1.0 / spec.arrival_rate))
        plen = int(rng.choice(np.asarray(spec.prompt_lens)))
        max_new = int(rng.choice(np.asarray(spec.max_news)))
        shared = bool(rng.random() < spec.shared_prefix_ratio)
        body = rng.integers(0, spec.vocab,
                            size=plen - (len(prefix) if shared else 0))
        prompt = np.concatenate([prefix, body]) if shared else body
        # only consume rng state for priorities when the mix is non-trivial,
        # so pre-degradation traces stay byte-identical (DESIGN.md §11)
        prio = int(rng.choice(np.asarray(spec.priorities))) \
            if len(spec.priorities) > 1 else int(spec.priorities[0])
        out.append(Arrival(t=t, request=Request(
            prompt=prompt.astype(np.int32), max_new=max_new,
            temperature=spec.temperature, eos_id=spec.eos_id,
            deadline_ms=spec.deadline_ms, priority=prio,
            seed=spec.seed * 100003 + i)))
    return out


def run_open_loop(engine: Engine, arrivals: Sequence[Arrival],
                  recorder=None, time_scale: float = 1.0,
                  ) -> Tuple[List[StreamHandle], float]:
    """Drive an engine with a wall-clock open-loop trace (DESIGN.md §10).

    Submits each arrival once real time reaches ``arrival.t * time_scale``
    (``time_scale`` compresses or stretches a trace without changing its
    shape — smoke runs use < 1), ticks the engine whenever it has work, and
    sleeps only when idle *and* ahead of the next arrival.  The engine is
    never blocked on the trace: queueing delay accrues to the requests, not
    to the device.  Returns ``(handles, makespan_seconds)``; drains the
    async host loop (when enabled) before returning so every handle is
    final.
    """
    # The open-loop runner is the ONE sanctioned wall-clock consumer in
    # serving/ (DESIGN.md §12, RL002): arrivals are *defined* against real
    # time, so the pacing loop below reads it directly — with explicit
    # waivers.  Everything it hands to the recorder is anchored on
    # engine.now() so the marks stay comparable with the engine's clock.
    arrivals = sorted(arrivals, key=lambda a: a.t)
    t0 = time.perf_counter()  # reprolint: disable=RL002 -- open-loop pacing is wall-clock by definition
    if recorder is not None:
        recorder.start(engine.now())
    handles: List[StreamHandle] = []
    idx = 0
    while True:
        now = time.perf_counter() - t0  # reprolint: disable=RL002 -- arrival schedule is in real seconds
        while idx < len(arrivals) and arrivals[idx].t * time_scale <= now:
            h = engine.submit(arrivals[idx].request)
            handles.append(h)
            if recorder is not None:
                recorder.on_submit(h, arrivals[idx].t * time_scale,
                                   time.perf_counter() - t0)  # reprolint: disable=RL002 -- trace-relative submit offset
            idx += 1
        worked = engine.step()
        if recorder is not None:
            recorder.on_step(engine, time.perf_counter() - t0)  # reprolint: disable=RL002 -- trace-relative step offset
        if not worked:
            if idx >= len(arrivals):
                break
            # idle and ahead of schedule: wait for the next arrival
            wait = arrivals[idx].t * time_scale - (time.perf_counter() - t0)  # reprolint: disable=RL002 -- pacing against real arrivals
            if wait > 0:
                time.sleep(min(wait, 0.05))  # reprolint: disable=RL002 -- idle wait for the next real arrival
    engine.drain()
    makespan = time.perf_counter() - t0  # reprolint: disable=RL002 -- makespan is a wall-clock quantity
    if recorder is not None:
        recorder.finalize()
    return handles, makespan
