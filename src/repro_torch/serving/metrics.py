"""Serving SLA accounting: TTFT/TPOT records, step samples, goodput
(port of ``repro.serving.metrics``; DESIGN.md §10).

The paper's decode-speedup claim is a closed-loop, batch-of-1 number; the
serving harness judges the engine the way a deployment is judged —
**goodput under offered load**: of the requests arriving at a given rate,
how many met their latency SLA, and what token throughput did those
requests sustain?  This module is the bookkeeping half of that story:

* :class:`RequestRecord` — one admitted request's timeline (arrival →
  submit → admit → first token → finish), all relative to the trace start,
  plus the derived TTFT (arrival to first delivered token — queue wait
  *included*, because the user waited through it) and TPOT (mean
  inter-token time after the first);
* :class:`MetricsRecorder` — collects records plus per-step samples
  (engine queue depth, host-loop queue depth, active slots, pool blocks
  used) during an open-loop run (``repro.serving.loadgen``);
* :meth:`MetricsRecorder.summary` — percentile tables at the offered
  load, achieved vs offered rate, and the goodput-under-SLA block;
* :func:`find_saturation` — sweep offered rates for the largest one whose
  SLA attainment clears a target: the saturation point row of the
  benchmark artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["RequestRecord", "MetricsRecorder", "percentiles", "goodput",
           "find_saturation"]

_PCTS = (50, 90, 99)


def percentiles(xs: Sequence[float], pcts=_PCTS) -> Dict[str, float]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` over ``xs`` (empty-safe) —
    the percentile-table format of DESIGN.md §10."""
    if not len(xs):
        return {f"p{q}": 0.0 for q in pcts}
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in pcts}


@dataclasses.dataclass
class RequestRecord:
    """One request's serving timeline, seconds relative to the trace start
    (DESIGN.md §10).  ``None`` marks events that never happened (a request
    still queued at shutdown has no ``admit_s``)."""
    rid: int
    arrival_s: float
    submit_s: float
    prompt_len: int
    max_new: int
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_tokens: int = 0
    finish_reason: Optional[str] = None

    @property
    def ttft_ms(self) -> Optional[float]:
        """Arrival -> first delivered token, ms (queue wait included)."""
        if self.first_token_s is None:
            return None
        return (self.first_token_s - self.arrival_s) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean time-per-output-token after the first, ms."""
        if self.finish_s is None or self.first_token_s is None \
                or self.n_tokens < 2:
            return None
        return (self.finish_s - self.first_token_s) * 1e3 \
            / (self.n_tokens - 1)

    @property
    def e2e_ms(self) -> Optional[float]:
        """Arrival -> finish, ms."""
        if self.finish_s is None:
            return None
        return (self.finish_s - self.arrival_s) * 1e3

    def meets_sla(self, sla_ttft_ms: Optional[float],
                  sla_tpot_ms: Optional[float]) -> bool:
        """True when this request finished inside both SLA bounds
        (``None`` bounds don't constrain) — the goodput predicate of
        DESIGN.md §10."""
        if self.finish_s is None:
            return False
        if sla_ttft_ms is not None and (self.ttft_ms is None
                                        or self.ttft_ms > sla_ttft_ms):
            return False
        if sla_tpot_ms is not None and self.tpot_ms is not None \
                and self.tpot_ms > sla_tpot_ms:
            return False
        return True


def goodput(records: Sequence[RequestRecord], makespan_s: float,
            sla_ttft_ms: Optional[float], sla_tpot_ms: Optional[float]
            ) -> dict:
    """Goodput-under-SLA block (DESIGN.md §10): attainment fraction,
    SLA-meeting request rate, and the token throughput those requests
    carried."""
    ok = [r for r in records if r.meets_sla(sla_ttft_ms, sla_tpot_ms)]
    span = max(makespan_s, 1e-9)
    return {
        "sla_ttft_ms": sla_ttft_ms, "sla_tpot_ms": sla_tpot_ms,
        "n_ok": len(ok),
        "attainment": len(ok) / max(len(records), 1),
        "goodput_rps": len(ok) / span,
        "goodput_tok_s": sum(r.n_tokens for r in ok) / span,
    }


class MetricsRecorder:
    """Collects request records + per-step samples during an open-loop run
    (DESIGN.md §10).  Driven by
    ``repro_torch.serving.loadgen.run_open_loop``;
    usable standalone around any Engine loop."""

    def __init__(self):
        self.records: Dict[int, RequestRecord] = {}
        self._handles: Dict[int, object] = {}
        self.samples: List[dict] = []
        self._t0_wall: Optional[float] = None

    def start(self, t0_wall: float) -> None:
        """Anchor handle timestamps to trace-relative seconds.  Pass
        ``engine.now()`` — the handles' marks are stamped from the engine's
        injectable clock (DESIGN.md §11), so the anchor must read the same
        source."""
        self._t0_wall = t0_wall

    def _rel(self, t_wall: Optional[float]) -> Optional[float]:
        if t_wall is None or self._t0_wall is None:
            return None
        return t_wall - self._t0_wall

    def on_submit(self, handle, arrival_s: float, now_s: float) -> None:
        """Record a submission (arrival per the trace, submit per the
        submission loop)."""
        req = handle.request
        self.records[handle.rid] = RequestRecord(
            rid=handle.rid, arrival_s=arrival_s, submit_s=now_s,
            prompt_len=len(req.prompt), max_new=req.max_new)
        self._handles[handle.rid] = handle

    def on_step(self, engine, now_s: float) -> None:
        """Sample per-step queue/occupancy gauges (DESIGN.md §10)."""
        sample = {
            "t": now_s,
            "queue_depth": engine.queue_depth,
            "active_slots": engine.active_slots,
            "host_queue_depth": (engine._host.queue_depth
                                 if getattr(engine, "_host", None) else 0),
        }
        if engine._pools:                        # one pool per band (§9)
            sample["pool_used"] = sum(p.used()
                                      for p in engine._pools.values())
        self.samples.append(sample)

    def finalize(self) -> None:
        """Fold the handles' engine-clock marks into the records (call
        after the engine drained)."""
        for rid, rec in self.records.items():
            h = self._handles.get(rid)
            if h is None:
                continue
            rec.admit_s = self._rel(getattr(h, "admit_time", None))
            rec.first_token_s = self._rel(h.first_token_time)
            rec.finish_s = self._rel(h.finish_time)
            rec.n_tokens = len(h.tokens)
            rec.finish_reason = h.finish_reason

    def summary(self, sla_ttft_ms: Optional[float] = None,
                sla_tpot_ms: Optional[float] = None) -> dict:
        """Percentile tables + offered/achieved load + goodput-under-SLA
        (DESIGN.md §10).  Offered load comes from the arrival trace;
        achieved from what actually finished — reporting both is what
        keeps open- and closed-loop rows comparable."""
        recs = list(self.records.values())
        done = [r for r in recs if r.finish_s is not None]
        reasons: Dict[str, int] = {}
        for r in recs:
            key = r.finish_reason if r.finish_reason is not None else "none"
            reasons[key] = reasons.get(key, 0) + 1
        last_arrival = max((r.arrival_s for r in recs), default=0.0)
        makespan = max((r.finish_s for r in done), default=0.0)
        n_toks = sum(r.n_tokens for r in done)
        out = {
            "n_requests": len(recs),
            "n_finished": len(done),
            "offered_rps": len(recs) / max(last_arrival, 1e-9),
            "achieved_rps": len(done) / max(makespan, 1e-9),
            "achieved_tok_s": n_toks / max(makespan, 1e-9),
            "makespan_s": makespan,
            "finish_reasons": reasons,
            "ttft_ms": percentiles([r.ttft_ms for r in recs
                                    if r.ttft_ms is not None]),
            "tpot_ms": percentiles([r.tpot_ms for r in recs
                                    if r.tpot_ms is not None]),
            "e2e_ms": percentiles([r.e2e_ms for r in recs
                                   if r.e2e_ms is not None]),
            "queue_wait_ms": percentiles(
                [(r.admit_s - r.submit_s) * 1e3 for r in recs
                 if r.admit_s is not None]),
        }
        if self.samples:
            for key in ("queue_depth", "host_queue_depth", "active_slots",
                        "pool_used"):
                vals = [s[key] for s in self.samples if key in s]
                if vals:
                    out[f"{key}_max"] = max(vals)
                    out[f"{key}_mean"] = float(np.mean(vals))
        if sla_ttft_ms is not None or sla_tpot_ms is not None:
            out["goodput"] = goodput(done, makespan, sla_ttft_ms,
                                     sla_tpot_ms)
        return out


def find_saturation(eval_at_rate: Callable[[float], dict],
                    rates: Sequence[float],
                    attainment_target: float = 0.9) -> dict:
    """Saturation sweep (DESIGN.md §10): evaluate ascending offered rates
    and report the largest whose SLA attainment clears the target.

    ``eval_at_rate(rate)`` must return a :meth:`MetricsRecorder.summary`
    dict that includes a ``goodput`` block.  Stops early once a rate
    misses the target (offered load is monotone in queueing delay, so
    higher rates can only do worse)."""
    table = []
    best = None
    for rate in sorted(rates):
        s = eval_at_rate(rate)
        att = s["goodput"]["attainment"]
        table.append({"rate": rate, "attainment": att,
                      "goodput_rps": s["goodput"]["goodput_rps"],
                      "ttft_p90_ms": s["ttft_ms"]["p90"],
                      "tpot_p90_ms": s["tpot_ms"]["p90"]})
        if att >= attainment_target:
            best = rate
        else:
            break
    return {"saturation_rps": best, "attainment_target": attainment_target,
            "table": table}
