"""Spans from the harness's own files and the device trace of a slice.

:class:`Tracer` wraps the calls into each layer in ``record_function``
spans (``round_restore``, ``replays``, ``host_sync``) and, in a
``--trace 1`` run, profiles one slice of the
window with ``torch.profiler``.  :func:`read_trace` reduces the exported
trace to device intervals, their union (busy time), the idle gaps
labelled by the host span that was open, and the breakdown the result
line carries.  A slice with no device event raises: an empty trace never
reads as an idle share."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "traced_slice"
TOP = 10


class Tracer:
    """Spans only while the profiler runs; the profiler only between
    :meth:`start` and :meth:`stop`, and only when enabled.  The traced
    slice opens at :meth:`open_slice`, a step after the profiler starts,
    so the profiler's own start-up never reads as idle device time."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._slice = None
        self.trace: Optional["Trace"] = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.autograd.profiler.record_function(name)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        loads and initializes CUPTI, seconds that would otherwise fall
        inside the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    @property
    def in_slice(self) -> bool:
        return self._slice is not None

    def start(self) -> None:
        if not self.enabled or self._prof is not None or \
                self.trace is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()

    def open_slice(self) -> None:
        if self._prof is None or self._slice is not None:
            return
        import torch
        torch.cuda.synchronize()
        self._slice = torch.autograd.profiler.record_function(SLICE)
        self._slice.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch
        torch.cuda.synchronize()
        if self._slice is not None:
            self._slice.__exit__(None, None, None)
            self._slice = None
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = read_trace(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A traced slice: device operations ``(name, start_us, dur_us)``
    inside the slice, the slice's host interval, busy and idle time."""

    def __init__(self, device: List[tuple], spans: List[tuple],
                 window: Tuple[float, float]):
        self.window = window
        w0, w1 = window
        self.device = [(n, max(s, w0), min(s + d, w1) - max(s, w0))
                       for n, s, d in device if s + d > w0 and s < w1]
        if not self.device:
            raise RuntimeError("the traced slice holds no device event: "
                               "the profiler saw no kernel")
        self.spans = spans
        self.busy = _union([(s, s + d) for _, s, d in self.device])
        self.busy_us = sum(b - a for a, b in self.busy)
        self.window_us = w1 - w0

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    @property
    def window_s(self) -> float:
        return self.window_us * 1e-6

    def time_by(self, predicate) -> float:
        """Seconds of device operations whose name satisfies
        ``predicate``."""
        return sum(d for n, _, d in self.device if predicate(n)) * 1e-6

    def gaps(self) -> List[Tuple[str, float]]:
        """Idle intervals of the slice, each labelled by the innermost
        harness span open at its middle."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        out = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                out.append((self._label((a + b) / 2), (b - a) * 1e-6))
        return out

    def _label(self, t: float) -> str:
        best, start = "untraced_host", -1.0
        for name, a, b in self.spans:
            if a <= t <= b and a > start:
                best, start = name, a
        return best

    def breakdown(self) -> Dict[str, list]:
        by: Dict[str, float] = {}
        for n, _, d in self.device:
            key = n if len(n) <= 120 else n[:117] + "..."
            by[key] = by.get(key, 0.0) + d * 1e-6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def read_trace(events: List[dict]) -> Trace:
    device, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), ts, dur))
        elif cat == "user_annotation":
            if e.get("name") == SLICE:
                window = (ts, ts + dur)
            else:
                spans.append((e.get("name", "?"), ts, ts + dur))
    if window is None:
        raise RuntimeError("the trace holds no traced_slice span")
    return Trace(device, spans, window)
