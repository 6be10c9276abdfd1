"""Async host loop: background stream delivery (port of
``repro.serving.host_loop``; DESIGN.md §10).

The synchronous engine materializes every decode chunk on the scheduler
thread (device->host copy, then the per-token delivery loop) before it may
launch the next chunk.  This module moves the host side of each chunk onto
a background consumer thread:

* the scheduler enqueues a :class:`TokenDelivery` per chunk.  On CUDA the
  chunk's tokens ride in a pinned host buffer that a ``non_blocking`` copy
  fills right after the chunk, with the CUDA event recorded behind that
  copy: a ``.cpu()`` on the consumer thread would instead queue behind the
  chunk the scheduler has already launched;
* a **bounded** queue provides backpressure: when the consumer falls
  behind, the scheduler's ``put`` blocks and the stall is accounted
  (``backpressure_waits`` / ``backpressure_s`` in ``Engine.stats()``)
  instead of letting delivery lag grow without bound;
* token streams are bit-identical to the synchronous loop: items are
  consumed FIFO, per-slot chunk order is preserved, and the per-request
  eos/max_new truncation is decided by the scheduler from device flags
  (never from the token values), so delivery is pure transport;
* shutdown is graceful: :meth:`HostLoop.drain` blocks until every
  enqueued item is delivered, :meth:`HostLoop.close` drains and joins the
  thread.  A consumer exception is captured and re-raised on the caller's
  thread at the next ``put``/``drain`` — it can't vanish into a daemon
  thread.

Fault containment (DESIGN.md §11): a transient consumer failure raised as
:class:`HostLoopCrash` is *contained*, not fatal: the loop counts the
crash, retries the same item in order (bounded retries), and keeps
serving.  Any other exception keeps the capture-and-re-raise contract.
The Engine passes its fault injector's ``on_consume`` as the
``fault_hook``; a retried item keeps its ring buffer until it is finally
consumed.  After a preemption, delivery runs the stream's replay filter
(``StreamHandle._absorb_replay``): regenerated tokens are checked against
the delivered ones and dropped.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["TokenDelivery", "HostLoop", "HostLoopCrash"]

_SENTINEL = object()
_CRASH_RETRIES = 3     # per-item HostLoopCrash retries before giving up


class HostLoopCrash(RuntimeError):
    """A transient, retryable consumer failure (DESIGN.md §11): the host
    loop retries the item in place (preserving FIFO delivery order and
    bit-identical streams) up to a bounded number of attempts before
    escalating to the fatal path."""


@dataclasses.dataclass
class TokenDelivery:
    """One chunk's worth of host work (DESIGN.md §10): deliver
    ``tokens[rows[i], :counts[i]]`` to ``handles[i]``, finishing the handle
    with ``reasons[i]`` when set.  ``tokens`` is a host array (or tensor);
    ``ready``, when set, is the CUDA event recorded behind the copy that
    fills it, and the consumer waits on it first.  ``release`` runs once
    the item is consumed (delivered or dropped after a failure): it frees
    the host buffer for reuse."""
    handles: Sequence          # StreamHandle per entry
    rows: Sequence[int]        # row of ``tokens`` for each handle
    counts: Sequence[int]      # tokens to deliver from that row
    reasons: Sequence[Optional[str]]   # finish reason or None (still going)
    tokens: object             # (B, n) int array on the host
    ready: Optional[object] = None     # torch.cuda.Event or None
    release: Optional[Callable[[], None]] = None


class HostLoop:
    """Bounded-queue background delivery thread (DESIGN.md §10).

    ``finish_fn(handle, reason)`` is the engine's finish hook (sets
    ``finished``/``finish_reason``/``finish_time``); ``detokenize`` is an
    optional ``tokens -> str`` hook whose output accumulates on
    ``handle.text``.  The thread starts lazily at the first :meth:`put`
    and is restartable after :meth:`close`, so one engine can serve
    multiple waves.
    """

    def __init__(self, finish_fn: Callable, detokenize: Optional[Callable]
                 = None, max_queue: int = 8,
                 fault_hook: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        # shared engine clock (DESIGN.md §11): first-token stamps and
        # backpressure accounting must be comparable with the scheduler's
        # marks, so both sides read the same injectable source
        self._clock = clock if clock is not None else time.monotonic
        self._finish = finish_fn
        self._detok = detokenize
        self._fault_hook = fault_hook   # may raise HostLoopCrash
        self.max_queue = max_queue
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # ---- backpressure / progress accounting (Engine.stats()) ----
        self.enqueued = 0
        self.delivered = 0
        self.backpressure_waits = 0
        self.backpressure_s = 0.0
        self.max_depth = 0
        self.crashes = 0        # HostLoopCrash occurrences survived (§11)
        self.retries = 0        # item re-consume attempts after a crash

    # ------------------------------------------------------------ scheduler side

    def put(self, item: TokenDelivery) -> None:
        """Enqueue one chunk's deliveries; blocks (with accounting) when
        the bounded queue is full (DESIGN.md §10 backpressure contract)."""
        self._raise_if_failed()
        self._ensure_thread()
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self.backpressure_waits += 1
            t0 = self._clock()
            self._q.put(item)
            self.backpressure_s += self._clock() - t0
        self.enqueued += 1
        self.max_depth = max(self.max_depth, self._q.qsize())

    def drain(self) -> None:
        """Block until every enqueued item has been delivered
        (DESIGN.md §10 graceful-drain contract)."""
        self._q.join()
        self._raise_if_failed()

    def close(self, drain: bool = True) -> None:
        """Drain (unless told otherwise) and join the consumer thread.
        After close the loop is restartable: the next :meth:`put` spawns a
        fresh thread (DESIGN.md §10)."""
        if self._thread is None:
            return
        if drain:
            self._q.join()
        self._q.put(_SENTINEL)
        self._thread.join()
        self._thread = None
        self._raise_if_failed()

    @property
    def queue_depth(self) -> int:
        """Instantaneous undelivered-item count (sampled per step by the
        open-loop metrics recorder — DESIGN.md §10)."""
        return self._q.qsize()

    def stats(self) -> dict:
        """Cumulative host-loop counters for ``Engine.stats()``
        (DESIGN.md §10)."""
        return {"enqueued": self.enqueued, "delivered": self.delivered,
                "queue_depth": self.queue_depth, "max_depth": self.max_depth,
                "backpressure_waits": self.backpressure_waits,
                "backpressure_s": round(self.backpressure_s, 6),
                "crashes": self.crashes, "retries": self.retries,
                "alive": self._thread is not None}

    # ------------------------------------------------------------- consumer side

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="repro-torch-host-loop", daemon=True)
            self._thread.start()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("host loop consumer failed") from err

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                if self._error is None:   # after a failure: drain, don't run
                    for attempt in range(_CRASH_RETRIES + 1):
                        try:
                            self._consume(item)
                            break
                        except HostLoopCrash as e:
                            # transient crash model (§11): retry the same
                            # item in place — FIFO order preserved, no
                            # delivery happened yet (the hook fires before
                            # any handle mutation)
                            self.crashes += 1
                            if attempt >= _CRASH_RETRIES:
                                self._error = e
                                break
                            self.retries += 1
            except BaseException as e:    # noqa: BLE001 — re-raised to caller
                self._error = e
            finally:
                if item is not _SENTINEL and item.release is not None:
                    item.release()
                self._q.task_done()

    def _consume(self, item: TokenDelivery) -> None:
        if self._fault_hook is not None:
            self._fault_hook(item)        # may raise HostLoopCrash (§11)
        if item.ready is not None:
            item.ready.synchronize()      # the chunk's copy has landed
        arr = np.asarray(item.tokens)
        now = self._clock()
        for h, row, n, reason in zip(item.handles, item.rows, item.counts,
                                     item.reasons):
            toks = h._absorb_replay(arr[row, :n]) \
                if getattr(h, "_absorb_replay", None) else \
                [int(t) for t in arr[row, :n]]
            if toks and h.first_token_time is None:
                h.first_token_time = now
            h.tokens.extend(toks)
            if self._detok is not None and toks:
                h.text += self._detok(toks)
            self.delivered += len(toks)
            if reason is not None:
                self._finish(h, reason)
