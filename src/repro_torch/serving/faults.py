"""Deterministic fault injection for the serving engine (port of
``repro.serving.faults``, a copy of its host-side logic; DESIGN.md §11).

Robustness claims are only as good as the faults they were tested against,
and faults that only occur "sometimes" cannot gate CI.  This module makes
the degradation ladder *rehearsable*: a seeded :func:`chaos_trace` expands
a :class:`ChaosSpec` into tick-indexed :class:`ChaosEvent` rows, and a
:class:`FaultInjector` attached to ``Engine(faults=)`` applies them at
exact scheduler ticks — never from wall time — so the same trace replayed
twice produces the same preemptions, the same FinishReasons, and
bit-identical surviving streams (the determinism contract gated in
tests/test_degradation.py on both backends, and for the port against the
reference in tests/test_torch_degradation.py).

Four fault models, one per degradation-ladder rung:

* ``pool`` — exhaustion burst: seize a fraction of every band pool's free
  blocks (``BlockPool.seize``, visible to the invariant audit as injector
  holds, not leaks) for ``duration`` ticks, forcing admission stalls and
  priority preemption.
* ``nan`` — numerical fault: flag the last-admitted active slot for logit
  poisoning via the decode scan's per-slot NaN guard; the engine
  quarantines the slot ("shed") without touching its neighbors.
* ``crash`` — host-loop consumer crash: the next delivery raises
  :class:`~repro_torch.serving.host_loop.HostLoopCrash`, which the loop
  contains by retrying the item in FIFO order.
* ``timeout`` — wedged device step: :meth:`FaultInjector.take_step_delay`
  reports a *deterministic* extra step duration (no real sleeping) that
  trips the engine's watchdog.

Everything here is host-side bookkeeping — no torch, no device traffic —
so injection never perturbs the captured decode graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .host_loop import HostLoopCrash

__all__ = ["FAULT_KINDS", "ChaosEvent", "ChaosSpec", "chaos_trace",
           "TickClock", "FaultInjector"]

FAULT_KINDS = ("pool", "nan", "crash", "timeout")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault (DESIGN.md §11): ``kind`` fires at scheduler
    tick ``tick`` (1-based, matching ``Engine.step`` counts).

    ``duration`` is kind-specific: ticks a ``pool`` seizure holds, or the
    number of consecutive decode chunks a ``timeout`` delays (enough to
    exceed the watchdog's trip streak).  ``magnitude`` likewise: the
    fraction of free blocks a ``pool`` burst seizes (0, 1], or the extra
    seconds a ``timeout`` adds to the measured step duration."""
    tick: int
    kind: str
    duration: int = 4
    magnitude: float = 0.5

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"ChaosEvent.kind must be one of "
                             f"{FAULT_KINDS}, got {self.kind!r}")
        if self.tick < 1:
            raise ValueError(f"ChaosEvent.tick must be >= 1, "
                             f"got {self.tick}")
        if self.duration < 1:
            raise ValueError(f"ChaosEvent.duration must be >= 1, "
                             f"got {self.duration}")
        if not 0.0 < self.magnitude:
            raise ValueError(f"ChaosEvent.magnitude must be > 0, "
                             f"got {self.magnitude}")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Seeded recipe for a chaos trace (DESIGN.md §11): ``n_events``
    faults drawn from ``kinds`` at uniform ticks in [1, horizon_ticks],
    all sharing ``duration`` / ``magnitude``.  Same spec, same trace —
    the replay-determinism contract starts here."""
    n_events: int = 4
    kinds: Sequence[str] = FAULT_KINDS
    horizon_ticks: int = 64
    duration: int = 4
    magnitude: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.n_events < 1:
            raise ValueError(f"ChaosSpec.n_events must be >= 1, "
                             f"got {self.n_events}")
        if self.horizon_ticks < 1:
            raise ValueError(f"ChaosSpec.horizon_ticks must be >= 1, "
                             f"got {self.horizon_ticks}")
        bad = [k for k in self.kinds if k not in FAULT_KINDS]
        if bad or not self.kinds:
            raise ValueError(f"ChaosSpec.kinds must be a non-empty subset "
                             f"of {FAULT_KINDS}, got {tuple(self.kinds)}")


def chaos_trace(spec: ChaosSpec) -> List[ChaosEvent]:
    """Expand a :class:`ChaosSpec` into a sorted, deterministic event list
    (DESIGN.md §11).  Pure function of the spec — the generator is seeded
    per call and nothing else is consulted, so traces are replayable and
    shareable as plain data."""
    rng = np.random.default_rng(spec.seed)
    ticks = np.sort(rng.integers(1, spec.horizon_ticks + 1,
                                 size=spec.n_events))
    kinds = rng.choice(np.asarray(list(spec.kinds)), size=spec.n_events)
    return [ChaosEvent(tick=int(t), kind=str(k), duration=spec.duration,
                       magnitude=spec.magnitude)
            for t, k in zip(ticks, kinds)]


class TickClock:
    """Deterministic virtual clock for ``Engine(clock=)`` (DESIGN.md §11):
    advances ``dt_s`` per scheduler tick (the engine calls :meth:`tick`
    once per ``step``), so request deadlines expire at reproducible ticks
    instead of wall-clock-dependent moments — the difference between a
    chaos trace that replays bit-identically and one that flakes."""

    def __init__(self, dt_s: float = 0.01):
        if dt_s <= 0:
            raise ValueError(f"dt_s must be > 0, got {dt_s}")
        self.dt_s = float(dt_s)
        self.now = 0.0

    def tick(self) -> None:
        """Advance one scheduler tick's worth of virtual time."""
        self.now += self.dt_s

    def __call__(self) -> float:
        return self.now


class FaultInjector:
    """Applies a chaos trace to a live engine, one scheduler tick at a
    time (DESIGN.md §11).

    Attach via ``Engine(faults=FaultInjector(events))``; the engine calls
    :meth:`on_tick` at the top of every ``step`` and
    :meth:`take_step_delay` after every decode chunk, and hands
    :meth:`on_consume` to the host loop as its fault hook.  All injections
    are deterministic functions of (trace, engine state at the tick):
    block seizures pop the pool free list in order, the NaN target is the
    last-admitted active slot, crash/timeout are armed counters — no
    wall-clock, no unseeded randomness, no real sleeping.
    """

    def __init__(self, events: Sequence[ChaosEvent]):
        self.events = sorted(events, key=lambda e: (e.tick, e.kind))
        self.tick = 0
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.skipped: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        # live holds: (release_tick, pool, block_ids)
        self._holds: List[Tuple[int, object, List[int]]] = []
        self._nan_pending = 0
        self._crash_armed = 0
        self._delay_steps = 0
        self._delay_s = 0.0

    # ------------------------------------------------------- engine hooks

    def on_tick(self, engine) -> None:
        """Advance one tick: release expired block seizures, fire this
        tick's events, and retry any deferred NaN injection
        (DESIGN.md §11)."""
        self.tick += 1
        live = []
        for release_tick, pool, blocks in self._holds:
            if release_tick <= self.tick:
                pool.release_seized(blocks)
            else:
                live.append((release_tick, pool, blocks))
        self._holds = live
        for ev in self.events:
            if ev.tick == self.tick:
                self._apply(engine, ev)
        if self._nan_pending > 0 and self._inject_nan(engine):
            self._nan_pending -= 1

    def take_step_delay(self) -> float:
        """Deterministic extra seconds to charge against the current decode
        chunk (the simulated device timeout of DESIGN.md §11); 0.0 when no
        timeout fault is active.  One armed fault delays ``duration``
        consecutive chunks — enough to cross a watchdog trip streak."""
        if self._delay_steps <= 0:
            return 0.0
        self._delay_steps -= 1
        return self._delay_s

    def on_consume(self, item) -> None:
        """Host-loop fault hook (DESIGN.md §11): when a crash fault is
        armed, raise :class:`HostLoopCrash` *before* any delivery happens,
        so the loop's in-place retry cannot double-deliver."""
        if self._crash_armed > 0:
            self._crash_armed -= 1
            raise HostLoopCrash(
                "fault injection: host-loop consumer crash (DESIGN.md §11)")

    # ----------------------------------------------------------- details

    def _apply(self, engine, ev: ChaosEvent) -> None:
        if ev.kind == "pool":
            seized_any = False
            for pool in engine._pools.values():
                n = int(pool.stats()["free"] * min(ev.magnitude, 1.0))
                if n < 1:
                    continue
                blocks = pool.seize(n)
                if blocks:
                    seized_any = True
                    self._holds.append((self.tick + ev.duration, pool,
                                        blocks))
            if seized_any:
                self.injected["pool"] += 1
            else:
                self.skipped["pool"] += 1
        elif ev.kind == "nan":
            if not self._inject_nan(engine):
                self._nan_pending += 1   # retried once slots are active
        elif ev.kind == "crash":
            self._crash_armed += 1
            self.injected["crash"] += 1
        elif ev.kind == "timeout":
            self._delay_steps = max(self._delay_steps, ev.duration)
            self._delay_s = max(self._delay_s, ev.magnitude)
            self.injected["timeout"] += 1

    def _inject_nan(self, engine) -> bool:
        """Flag the last-admitted active slot (deterministic target) for
        logit poisoning at the next decode chunk (DESIGN.md §11)."""
        best = None
        for i, h in enumerate(engine._slot_handle):
            if h is None or engine._h_done(h) or engine._nan_inject[i]:
                continue
            if best is None or engine._slot_seq[i] > engine._slot_seq[best]:
                best = i
        if best is None:
            return False
        engine._nan_inject[best] = True
        self.injected["nan"] += 1
        return True

    @property
    def done(self) -> bool:
        """True once every event fired and no seizure is still held —
        chaos runs gate on this before auditing invariants
        (DESIGN.md §11)."""
        return (self.tick >= max((e.tick for e in self.events), default=0)
                and not self._holds and self._nan_pending == 0)

    def stats(self) -> dict:
        """Injection accounting for the degradation summary table and the
        chaos bench rows (DESIGN.md §11)."""
        return {"tick": self.tick,
                "injected": dict(self.injected),
                "skipped": dict(self.skipped),
                "active_holds": len(self._holds),
                "crash_armed": self._crash_armed,
                "delay_steps": self._delay_steps}
