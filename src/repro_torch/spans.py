"""Regions of the port's code, and the map that puts every device operation
of a captured step under the region that launched it.

:func:`region` names a stretch of host code.  It does one of three things:

* while :func:`capture` records a CUDA-graph capture, it notes how many
  device nodes (kernel, memcpy and memset nodes) the capture held when the
  region opened and when it closed (``csrc/spans.cu``), which gives the
  region's first operation and its count in the graph: a row of the
  graph's :class:`OpMap`.  This costs host time once per capture and
  nothing per replay;
* while ``torch.profiler`` runs and nothing is recorded, it opens a
  ``record_function`` span of the same name, so eager steps get host spans
  on the profiler's clock;
* otherwise nothing, beyond those two checks.

Host spans do not reach the kernels of a replayed graph: the profiler ties
each of them to the one graph launch.  :func:`capture` therefore also
captures an empty ``repro_replay_begin`` kernel first and an empty
``repro_replay_end`` kernel last.  The nodes of a single-stream capture
run in the order they were captured, so :func:`attribute` can lay the map
onto a device trace: the operations between two markers are one replay,
the i-th of them is the map's i-th operation.

Regions nest; a row's path names its parents (``layer.3/attn.perm``).
The leaves partition what they cover, and an operation under no leaf is
:data:`OTHER`.  :func:`op_maps` holds the newest map of each graph name,
process-wide, as ``kernels.launch_counts`` holds the launches.
:func:`span` is the profiler-only half of :func:`region`, for host code
that is never captured (the graph cache's own launch)."""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .kernels import _build

__all__ = ["BEGIN", "END", "OTHER", "OpMap", "Row", "Attribution", "region",
           "span", "record", "capture", "op_maps", "attribute"]

BEGIN, END = "repro_replay_begin", "repro_replay_end"
OTHER = "other"


@dataclasses.dataclass(frozen=True)
class Row:
    """One region of a capture: its path, its first operation (an index
    into the capture's device operations) and its number of operations."""
    path: str
    first: int
    count: int


@dataclasses.dataclass(frozen=True)
class OpMap:
    """The regions of one capture in the order they opened, and the number
    of device operations the capture holds."""
    rows: Tuple[Row, ...]
    total: int

    def leaves(self) -> List[Row]:
        """The rows of regions that hold no other region, in order."""
        parents = {r.path.rsplit("/", 1)[0] for r in self.rows
                   if "/" in r.path}
        return [r for r in self.rows if r.path not in parents]

    def owners(self) -> List[str]:
        """The path of the leaf region of each operation, or :data:`OTHER`
        for one under no leaf."""
        out = [OTHER] * self.total
        for r in self.leaves():
            out[r.first:r.first + r.count] = [r.path] * r.count
        return out

    def as_rows(self) -> List[list]:
        """``[path, first, count]`` rows, for a report."""
        return [[r.path, r.first, r.count] for r in self.rows]


class _Recorder:
    def __init__(self, count: Callable[[], int]):
        self._count = count
        self._base = count()
        self._open: List[Tuple[str, int]] = []
        self._rows: List[list] = []
        self.map: Optional[OpMap] = None      # set when the recording ends

    def _now(self) -> int:
        return self._count() - self._base

    def enter(self, name: str) -> None:
        path = "/".join([p for p, _ in self._open] + [name])
        self._open.append((name, len(self._rows)))
        self._rows.append([path, self._now(), 0])

    def exit(self, failed: bool = False) -> None:
        _, i = self._open.pop()
        if not failed:          # a failed capture keeps no map: count nothing
            self._rows[i][2] = self._now() - self._rows[i][1]

    def close(self) -> None:
        if self._open:
            raise RuntimeError(f"regions still open: {self._open}")
        self.map = OpMap(tuple(Row(*r) for r in self._rows), self._now())


_RECORDER: Optional[_Recorder] = None
_MAPS: Dict[str, OpMap] = {}


class region:
    """Context manager naming a stretch of the port's code (module
    docstring)."""
    __slots__ = ("name", "_ctx")

    def __init__(self, name: str):
        self.name = name
        self._ctx = None

    def __enter__(self):
        if _RECORDER is not None:
            _RECORDER.enter(self.name)
            self._ctx = _RECORDER
        elif torch.autograd.profiler._is_profiler_enabled:
            self._ctx = torch.autograd.profiler.record_function(self.name)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        ctx, self._ctx = self._ctx, None
        if isinstance(ctx, _Recorder):
            ctx.exit(exc[0] is not None)
        elif ctx is not None:
            ctx.__exit__(*exc)
        return False


def span(name: str):
    """A ``record_function`` span while the profiler runs, else nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.autograd.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def record(count: Callable[[], int]):
    """Record the regions opened inside the block against ``count()``, the
    number of operations captured so far; yields the recording, whose
    ``map`` is the :class:`OpMap` once the block has closed."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a capture is recorded already")
    _RECORDER = rec = _Recorder(count)
    try:
        yield rec
    finally:
        _RECORDER = None
    rec.close()


def _lib():
    lib = _build.load("spans")
    if lib.spans_marker_launch.argtypes is None:
        lib.spans_marker_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.spans_marker_launch.restype = ctypes.c_int
        lib.spans_capture_device_nodes.argtypes = [ctypes.c_void_p]
        lib.spans_capture_device_nodes.restype = ctypes.c_longlong
    return lib


def _device_nodes(lib, stream: int) -> int:
    n = lib.spans_capture_device_nodes(stream)
    if n < 0:
        raise RuntimeError("the stream is not capturing" if n == -1 else
                           f"counting the captured nodes failed: cudaError "
                           f"{-2 - n}")
    return n


@contextlib.contextmanager
def capture(name: str):
    """Inside ``torch.cuda.graph``: capture the begin marker, record the
    block's regions, capture the end marker, and keep the map as the
    newest of graph ``name`` (:func:`op_maps`).  Yields the recording of
    :func:`record`."""
    lib = _lib()
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib.spans_marker_launch(0, stream), BEGIN)
    with record(lambda: _device_nodes(lib, stream)) as rec:
        yield rec
    _build.check(lib.spans_marker_launch(1, stream), END)
    _MAPS[name] = rec.map


def op_maps() -> Dict[str, OpMap]:
    """The newest :class:`OpMap` of each captured graph name."""
    return dict(_MAPS)


@dataclasses.dataclass(frozen=True)
class Attribution:
    """Device seconds of each leaf path (and :data:`OTHER`) summed over
    ``replays`` whole replays."""
    seconds: Dict[str, float]
    replays: int

    def by_name(self) -> Dict[str, float]:
        """Seconds by a leaf's own name, its layers summed
        (``attn.perm``)."""
        out: Dict[str, float] = {}
        for path, s in self.seconds.items():
            leaf = path.rsplit("/", 1)[-1]
            out[leaf] = out.get(leaf, 0.0) + s
        return out


def attribute(device_ops: Iterable[tuple], op_map: OpMap
              ) -> Optional[Attribution]:
    """Put the device operations ``(name, start_us, dur_us)`` of a
    profiler's trace (its chrome trace's microseconds) under the regions
    of ``op_map``: every replay that lies whole between a
    ``repro_replay_begin`` and a ``repro_replay_end`` marker must hold
    ``op_map.total`` operations, and its i-th one goes to the i-th
    operation's leaf.  Operations of replays cut by the ends of the list
    are left out.  None if a whole replay does not match the map."""
    ops = sorted(device_ops, key=lambda o: o[1])
    owners = op_map.owners()
    seconds: Dict[str, float] = {}
    replays, begin = 0, None
    for i, (name, _, _) in enumerate(ops):
        if name == BEGIN:
            begin = i
        elif name == END and begin is not None:
            inner = ops[begin + 1:i]
            if len(inner) != op_map.total:
                return None
            for owner, (_, _, dur) in zip(owners, inner):
                seconds[owner] = seconds.get(owner, 0.0) + dur * 1e-6
            replays += 1
            begin = None
    return Attribution(seconds, replays)
