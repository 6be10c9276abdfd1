"""CUDA-graph warmup cache (port of ``repro.serving.warmup``; DESIGN.md
§10).

The reference AOT-compiles every executable the steady state can reach
and dispatches serve-time calls through its ``ExecutableCache``, so no
request pays a compile or a per-op host dispatch.  PyTorch runs eagerly;
its counterpart of one compiled executable per shape is a captured CUDA
graph.  :class:`GraphCache` keys graphs by ``(name, shape_signature)``:

* :meth:`GraphCache.warm` runs the side-stream warmup iterations the
  PyTorch documentation prescribes, then captures ``fn`` on its static
  input tensors under ``torch.cuda.graph`` and keeps the graph with the
  static inputs and outputs.  A capture that fails raises; nothing falls
  back to eager quietly.  On ``device="cpu"`` (tests only) it records the
  signature and captures nothing, so the bookkeeping runs here.
* :meth:`GraphCache.call` copies the inputs into the static buffers (an
  input that IS its static buffer is not copied) and replays on a hit; on
  a miss it runs ``fn`` eagerly.  A miss first seen after :attr:`warmed`
  is recorded in ``post_warmup_misses``: the counterpart of the
  reference's ``post_warmup_compiles`` (work that reached traffic
  without having been prepared), whose contract is that it stays 0.

Each capture also records its region map (:mod:`repro_torch.spans`): the
empty ``repro_replay_begin`` / ``repro_replay_end`` kernels open and
close the graph, and every :func:`spans.region` inside ``fn`` becomes a
row of the graph's map, kept in its entry, in :meth:`GraphCache.report`
and in ``spans.op_maps()``.  While the profiler runs, :meth:`call` opens
the host spans ``graph.call:<name>`` and, inside it, ``graph.copy_in:<name>``
around the static-input copy and ``graph.launch:<name>`` around the
replay.

A replay launches the captured kernels without running the Python
wrappers that count them (``repro_torch.kernels.launch_counts``), so a
capture records the counters' delta, takes it back off (the capture
itself launches nothing), and every replay adds it once.

The graph is bound to the addresses of everything it reads and writes:
the static inputs, and whatever ``fn`` closes over (for the Engine, its
params and cache buffers).  None of them may be reallocated afterwards.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import spans
from ..kernels import add_launch_counts, launch_count_delta, launch_counts

__all__ = ["shape_signature", "GraphCache"]

WARMUP_ITERS = 3       # eager side-stream iterations before a capture


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shape_signature(tensors) -> tuple:
    """Hashable (shape, dtype) signature of the tensor leaves of a call's
    arguments (dicts, lists and tuples are walked; None is a leaf of its
    own) — DESIGN.md §10.  Equal signatures replay the same graph."""
    return tuple((tuple(x.shape), str(x.dtype)) if torch.is_tensor(x)
                 else (type(x).__name__,) for x in _leaves(tensors))


@dataclasses.dataclass
class _Entry:
    graph: Any                 # torch.cuda.CUDAGraph, or None on the CPU
    static_in: List[Any]
    static_out: Any
    delta: Optional[dict]
    op_map: Optional[spans.OpMap]


class GraphCache:
    """Named, shape-keyed cache of captured CUDA graphs (DESIGN.md §10).

    ``device`` is the engine's; ``clock`` (the engine's injectable clock,
    DESIGN.md §11) times each warm.  ``replays`` counts graph replays."""

    def __init__(self, device, clock: Optional[Callable[[], float]] = None):
        self.device = torch.device(device)
        self._clock = clock if clock is not None else time.monotonic
        self._entries: Dict[Tuple[str, tuple], _Entry] = {}
        self.entries: List[dict] = []       # one row per warmed signature
        self.warmed = False                 # set by Engine.warmup()
        self.replays = 0
        self._cold: Dict[Tuple[str, tuple], None] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_graphs(self) -> int:
        """Captured graphs (0 on the CPU, where nothing is captured)."""
        return sum(e.graph is not None for e in self._entries.values())

    @property
    def post_warmup_misses(self) -> int:
        """Distinct (name, signature) calls that found no graph after the
        cache was marked warm — the reference's ``post_warmup_compiles``;
        0 is the serving contract (DESIGN.md §10)."""
        return len(self._cold)

    def warm(self, name: str, fn: Callable, static_args: tuple) -> float:
        """Capture ``fn(*static_args)`` as a CUDA graph (DESIGN.md §10);
        returns the seconds taken, warmup iterations included (0.0 if the
        signature is warm already).  The warmup iterations really run
        ``fn``: whatever state it updates in place, the caller restores."""
        key = (name, shape_signature(static_args))
        if key in self._entries:
            return 0.0
        t0 = self._clock()
        graph = out = delta = op_map = None
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    fn(*static_args)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            # no cyclic collection inside the capture: it could free a dead
            # object's CUDA resources (pinned host buffers query their
            # events), which a capture in progress refuses
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    with spans.capture(name) as regions:
                        out = fn(*static_args)
            finally:
                if collecting:
                    gc.enable()
            op_map = regions.map
            delta = launch_count_delta(before, launch_counts())
            add_launch_counts(delta, -1)    # the capture launched nothing
            torch.cuda.synchronize(self.device)
        dt = self._clock() - t0
        self._entries[key] = _Entry(graph, _leaves(static_args), out, delta,
                                    op_map)
        self.entries.append({"name": name, "seconds": dt,
                             "n_leaves": len(key[1]),
                             "captured": graph is not None,
                             "ops": op_map.total if op_map else 0,
                             "regions": op_map.as_rows() if op_map else []})
        return dt

    def call(self, name: str, fn: Callable, *args):
        """Replay the graph of ``(name, signature)`` after copying ``args``
        into its static inputs and return its static outputs (overwritten
        by the next replay); run ``fn`` eagerly on a miss, recording it
        when warm (DESIGN.md §10)."""
        key = (name, shape_signature(args))
        e = self._entries.get(key)
        if e is None:
            if self.warmed and key not in self._cold:
                self._cold[key] = None
            return fn(*args)
        if e.graph is None:                 # CPU: bookkeeping only
            return fn(*args)
        with spans.span(f"graph.call:{name}"):
            with spans.span(f"graph.copy_in:{name}"):
                for dst, src in zip(e.static_in, _leaves(args)):
                    if torch.is_tensor(dst) and not (
                            src.data_ptr() == dst.data_ptr()
                            and src.stride() == dst.stride()):
                        dst.copy_(src)
            with spans.span(f"graph.launch:{name}"):
                e.graph.replay()
            add_launch_counts(e.delta)
        self.replays += 1
        return e.static_out

    def report(self) -> dict:
        """Warmup accounting for ``Engine.warmup_report()`` (DESIGN.md
        §10): graph count, capture seconds, per-signature rows (each with
        its captured device operations and its region map's ``[path,
        first, count]`` rows), replays, and the post-warmup miss counter
        the smoke run gates on."""
        return {
            "warmed": self.warmed,
            "n_graphs": self.n_graphs,
            "n_signatures": len(self._entries),
            "capture_s": round(sum(e["seconds"] for e in self.entries), 4),
            "graphs": list(self.entries),
            "replays": self.replays,
            "post_warmup_misses": self.post_warmup_misses,
            "cold_names": sorted({n for n, _ in self._cold}),
        }
