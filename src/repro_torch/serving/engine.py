"""Request-level serving engine, main path (port of
``repro.serving.engine``; DESIGN.md §6).

* :class:`Request` — prompt, max_new, temperature, eos_id, seed.
* :class:`Engine` — ``submit() -> StreamHandle``, ``step()``, ``run()``
  over ``batch_slots`` decode lanes.  Admission prefills queued requests
  whole-prompt (equal prompt lengths batch together) into free slots only,
  or, with ``prefill_chunk``, streams one prompt at a time through the
  cache in bucket-padded chunks, at most one chunk per ``step()``
  between decode chunks (DESIGN.md §7); retirement zeroes the slot.
  Decode runs ``steps_per_sync`` tokens per host sync
  (:func:`multi_decode`): tokens, EOS pinning and the per-slot
  ``live``/``done``/``bad`` flags stay on the device, and one copy per
  chunk brings them to the host.
* :class:`ServeSession` — the lock-step array shim over :class:`Engine`.

The serving harness of DESIGN.md §10: :meth:`Engine.warmup` loads the
kernel libraries, captures ONE decode step (:func:`decode_one`) as a CUDA
graph on the engine's own cache buffers (``serving/warmup.py``), replays
it ``steps_per_sync`` times per chunk, and rehearses one throwaway request;
``async_host=True`` delivers tokens on the background host loop
(``serving/host_loop.py``); ``serving/loadgen.py`` and
``serving/metrics.py`` drive open-loop traffic and score it against an
SLA.  The graph is bound to buffer addresses, so the caches and the
static uniforms buffer are never reallocated after capture: admission,
retirement, the copy-on-write pass and the table flush all write in
place.  An engine that is never warmed runs the eager
:func:`multi_decode` exactly as before.

The per-slot cache length (``cache["length"]`` is ``(B,)``) is what lets
slots at different positions decode in one batched step.  All engine time
flows through the injectable ``clock=`` (DESIGN.md §11).

``policy`` may be a per-layer schedule (DESIGN.md §8): fp16 guard layers
and bits ladders run as contiguous equal-policy bands with band-keyed
caches; a uniform schedule is bitwise the bare policy.

With ``pool_blocks`` (or ``pool_memory_bytes``) the packed planes of every
quantized band live in a shared pool of physical blocks, one pool per
band with the same block count (DESIGN.md §9); fp16 bands stay striped.
Each slot owns a block table per band, admission looks prompt blocks up
by content hash (a hit refs a resident block, only a miss is inserted
from the prefill), admission is FIFO in blocks and checks every band's
demand, a copy-on-write pass before every decode chunk makes private the
blocks its ring evictions will write, and decode attends through the
block-table mode of the decode_attn kernel.

The degradation ladder and fault model of DESIGN.md §11: requests carry
a ``deadline_ms`` and a ``priority``, and a handle can ``cancel()``; a
deadline, a cancel or a NaN quarantine ends one stream with a structured
:class:`FinishReason` and frees its blocks in the same tick.  Under pool
pressure the queue head (ordered by priority, then arrival) preempts
strictly-lower-priority slots, youngest first; a victim requeues and is
recomputed from its prompt, and the replay filter asserts that the tokens
it regenerates equal those already delivered.  With ``host_spill_bytes``
a registered block whose last reference drops parks its bytes in an LRU
host tier (:class:`~repro_torch.core.block_pool.HostSpillTier`) and a
later admission of the same content restores them instead of inserting
them from its prefill.  A watchdog sheds everything after
``watchdog_max_trips`` consecutive decode chunks over ``step_timeout_s``,
and ``faults=`` (``serving/faults.py``) injects the seeded chaos of the
reference at exact scheduler ticks.  ``detokenize`` grows
``handle.text`` in the synchronous loop and on the host loop.

Greedy streams match the reference engine token for token.  Sampling
(temperature > 0) uses a per-slot ``torch.Generator`` seeded from the
engine and request seeds, so a stream is reproducible per seed but is not
``jax.random``'s; a resumed request gets a fresh generator and redraws the
rows it drew before, so its replay is bit-identical too.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..core import kv_cache as kvc
from ..core import segments as seg
from ..core.block_pool import BlockPool, HostSpillTier, prefix_block_keys
from ..core.policy import QuantPolicy, as_schedule
from ..device import resolve_device
from ..models.config import ArchConfig
from ..models import backends as bk
from ..models import transformer as T
from .host_loop import HostLoop, TokenDelivery
from .warmup import GraphCache


# ------------------------------------------------------------------ sampling

def check_servable(cfg: ArchConfig) -> None:
    """Refuse a config the Engine cannot serve: an encoder-decoder, whose
    prefill needs each request's encoder frames (``enc_embeds``) where a
    :class:`Request` carries only a prompt.  The reference Engine prefills
    prompts alone and would fail inside its encoder at the first
    admission; an enc-dec model runs through
    ``transformer.prefill_model(..., enc_embeds=)`` and
    ``transformer.decode_step`` (DESIGN.md §6)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"the Engine serves decoder-only families; {cfg.name} "
            f"(family='encdec') needs encoder frames per request, which a "
            f"Request does not carry: run it through "
            f"transformer.prefill_model(..., enc_embeds=) and "
            f"transformer.decode_step")


def sample_per_slot(logits: torch.Tensor, temps: torch.Tensor,
                    uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling (DESIGN.md §6): logits (B, V), temps (B,),
    uniforms (B, V) in [0, 1) or None -> (B,) int64.

    Rows with ``temps <= 0`` take the greedy argmax; others draw from the
    temperature-scaled categorical by the Gumbel-max trick on their own
    uniforms."""
    greedy = torch.argmax(logits, dim=-1)
    if uniforms is None:
        return greedy
    gumbel = -torch.log(-torch.log(uniforms.clamp(1e-20, 1.0 - 1e-7)))
    scaled = logits.to(torch.float32) / temps.clamp_min(1e-6)[:, None]
    samp = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps > 0, samp, greedy)


def decode_one(params, cfg: ArchConfig, policy, token, caches, done, bad,
               live, temps, eos, uniforms: Optional[torch.Tensor] = None,
               calib=None, backend=None,
               nan_inject: Optional[torch.Tensor] = None):
    """One decode step with per-slot sampling and EOS pinning, all on the
    device: the body of :func:`multi_decode` (the reference's scan body),
    and what :meth:`Engine.warmup` captures as a CUDA graph (DESIGN.md
    §6, §10).  It reads nothing back to the host and copies nothing from
    it, so one capture replays for every step.

    token (B, 1), done / bad (B,) bool, live (B,) int32, temps (B,) f32,
    eos (B,) (< 0 disables EOS for that slot), uniforms (B, V) draws or
    None.  Returns (next token (B,), done, bad, live) as new tensors:
    ``live`` counts tokens emitted before pinning (the EOS token
    included); a slot whose logits go non-finite raises ``bad``, samples
    from zeroed logits and pins ``done``.  ``caches`` are updated in
    place.

    ``nan_inject`` (B,) bool is the per-slot NaN guard's test hook
    (DESIGN.md §11): a flagged row's logits become NaN before the ``bad``
    test, the path a numerically misbehaving model would take.  With
    every flag False the ``where`` is the identity, so the guarded step is
    bitwise the unguarded one (None leaves the guard out)."""
    logits, _ = T.decode_step(params, cfg, token, caches, policy,
                              calib=calib, backend=backend)
    with spans.region("head"):
        row = logits[:, -1].to(torch.float32)
        if nan_inject is not None:
            row = torch.where(nan_inject[:, None],
                              torch.full_like(row, float("nan")), row)
        bad = bad | ~torch.isfinite(row).all(dim=-1)
        safe = torch.where(bad[:, None], torch.zeros_like(row), row)
        nxt = sample_per_slot(safe, temps, uniforms)
        has = eos >= 0
        nxt = torch.where(done & has, eos.to(nxt.dtype), nxt)
        live = live + torch.where(done | bad, 0, 1).to(torch.int32)
        done = done | (has & (nxt == eos)) | bad
        return nxt, done, bad, live


def multi_decode(params, cfg: ArchConfig, policy, n_tokens: int, token,
                 caches, done, temps, eos, calib=None, backend=None,
                 uniforms: Optional[Callable] = None,
                 nan_inject: Optional[torch.Tensor] = None):
    """``n_tokens`` eager :func:`decode_one` steps (DESIGN.md §6; the
    reference's scanned multi-decode).

    token (B, 1), done (B,) bool, temps (B,) f32, eos (B,) (< 0 disables
    EOS for that slot).  ``uniforms()`` returns (B, V) draws or None;
    ``nan_inject`` is the (B,) NaN guard of every step (DESIGN.md §11).
    Returns (tokens (B, n), token, caches, done, bad, live).  ``caches``
    are updated in place."""
    b = token.shape[0]
    bad = torch.zeros(b, dtype=torch.bool, device=token.device)
    live = torch.zeros(b, dtype=torch.int32, device=token.device)
    out = []
    for _ in range(n_tokens):
        nxt, done, bad, live = decode_one(
            params, cfg, policy, token, caches, done, bad, live, temps, eos,
            None if uniforms is None else uniforms(), calib=calib,
            backend=backend, nan_inject=nan_inject)
        token = nxt[:, None]
        out.append(nxt)
    return torch.stack(out, dim=1), token, caches, done, bad, live


# ------------------------------------------------------------------ requests

class FinishReason:
    """Stream-termination taxonomy (DESIGN.md §11).

    Every stream ends with exactly one *terminal* reason: ``OK`` (generic
    success, for tooling), ``EOS``, ``LENGTH`` (max_new), ``DEADLINE``
    (``Request.deadline_ms`` expired, queued or running), ``CANCELLED``
    (``StreamHandle.cancel()``) or ``SHED`` (dropped by the engine: NaN
    quarantine or watchdog abort).  ``PREEMPTED`` is an *event*, not a
    terminal state: a preempted request requeues, is recomputed from its
    prompt and still ends with a terminal reason; the event is recorded in
    ``StreamHandle.events``.  The no-hung-streams invariant is
    ":meth:`valid` for every handle"."""
    OK = "ok"
    EOS = "eos"
    LENGTH = "length"
    DEADLINE = "deadline"
    CANCELLED = "cancelled"
    PREEMPTED = "preempted-requeued"
    SHED = "shed"
    TERMINAL = frozenset({OK, EOS, LENGTH, DEADLINE, CANCELLED, SHED})

    @classmethod
    def valid(cls, reason) -> bool:
        """True iff ``reason`` is a terminal FinishReason (DESIGN.md §11)."""
        return reason in cls.TERMINAL


@dataclasses.dataclass
class Request:
    """One generation job (DESIGN.md §6): prompt (1-D token ids), max_new
    budget, temperature (<= 0 greedy), optional eos_id, and a seed for the
    request's own sampling stream.

    ``deadline_ms`` and ``priority`` are the degradation-ladder knobs of
    DESIGN.md §11: a request still queued or running ``deadline_ms`` after
    submit (on the engine clock) ends ``deadline`` and frees its blocks at
    once; under pool pressure the queue head preempts running requests of
    *strictly lower* priority (larger = more important)."""
    prompt: Sequence[int]
    max_new: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    deadline_ms: Optional[float] = None
    priority: int = 0


class StreamHandle:
    """Live view of one submitted request (DESIGN.md §6): ``tokens`` grows
    after every sync (with ``async_host``, as the host loop delivers;
    DESIGN.md §10); ``finished``/``finish_reason`` flip at a terminal
    :class:`FinishReason`; submit/admit/first-token/finish marks come from
    the engine clock (the first token's mark survives preemptions).
    ``preempted`` counts evictions, ``events`` records them (DESIGN.md
    §11)."""

    def __init__(self, request: Request, rid: int,
                 now: Optional[float] = None):
        self.request = request
        self.rid = rid
        self.tokens: List[int] = []
        self.text = ""                     # grows when a detokenizer is set
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.submit_time = now
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.preempted = 0                 # times evicted + requeued (§11)
        self.events: List[str] = []        # non-terminal lifecycle events
        self._sched_consumed = 0           # tokens the scheduler committed
        self._sched_fin: Optional[str] = None  # scheduler's finish verdict
        self._cancel = False               # set by cancel(); acted on in step
        self._t_submit: Optional[float] = None  # deadline epoch (engine clock)
        self._replay_len = 0               # delivered tokens to replay (§11)
        self._replay_cursor = 0

    def cancel(self) -> None:
        """Cooperative cancellation (DESIGN.md §11): the engine ends the
        stream ``cancelled`` at its next tick; a queued request never takes
        a slot, a running one frees its blocks at once.  Idempotent; a
        no-op once the stream has finished."""
        self._cancel = True

    def result(self) -> np.ndarray:
        """The generated tokens so far as a 1-D int32 array."""
        return np.asarray(self.tokens, np.int32)

    def _absorb_replay(self, tokens) -> List[int]:
        """Replay filter (DESIGN.md §11): a preempted request is recomputed
        from its prompt, so the device regenerates tokens already
        delivered.  They must equal what the stream holds (raises
        otherwise) and are dropped; only the new suffix is returned."""
        if self._replay_cursor >= self._replay_len:
            return [int(t) for t in tokens]
        fresh: List[int] = []
        for t in tokens:
            t = int(t)
            if self._replay_cursor < self._replay_len:
                want = self.tokens[self._replay_cursor]
                if t != want:
                    raise RuntimeError(
                        f"preemption replay diverged for rid={self.rid}: "
                        f"position {self._replay_cursor} regenerated {t} "
                        f"but {want} was already delivered — "
                        f"recompute-from-prompt must be bit-identical "
                        f"(DESIGN.md §11)")
                self._replay_cursor += 1
            else:
                fresh.append(t)
        return fresh

    def __repr__(self):
        state = self.finish_reason if self.finished else "running"
        return f"StreamHandle(rid={self.rid}, tokens={len(self.tokens)}, {state})"


# -------------------------------------------------------------------- engine

def default_chunk_buckets(prefill_chunk: int) -> tuple:
    """Power-of-2 bucket ladder ``(…, C/4, C/2, C)`` down to 8 (DESIGN.md
    §7): every prompt runs as full-``C`` chunks plus one tail chunk padded
    to the smallest bucket that fits it, at most 2x padding on the tail."""
    out, b = [], prefill_chunk
    while b >= 8:
        out.append(b)
        b //= 2
    if not out:
        out = [prefill_chunk]
    return tuple(sorted(out))


@dataclasses.dataclass
class _PrefillJob:
    """Chunked-prefill progress (DESIGN.md §7): ``handle`` prefills into
    reserved slot ``slot``; ``pos`` prompt tokens are already in ``state``
    (the growing caches + the fp workspace).  One job runs at a time,
    advanced by at most one chunk per :meth:`Engine.step`."""
    handle: StreamHandle
    slot: int
    pos: int
    state: Dict


class Engine:
    """Continuous-batching engine over ``batch_slots`` decode lanes
    (DESIGN.md §6).

    ``policy`` is a :class:`~repro_torch.core.policy.QuantPolicy`, a
    :class:`~repro_torch.core.policy.PolicySchedule` or a preset
    (DESIGN.md §8); ``engine.schedule`` is the materialized schedule, and
    ``engine.policy`` the bare policy given, or that schedule.
    ``backend`` is ``"cuda"``, ``"reference"``, an instance,
    or None for the device's default (``"cuda"`` on a card).  ``max_len``
    is the per-slot cache capacity: ``len(prompt) + max_new <= max_len``
    is checked at submit.  ``dtype`` casts the params once, here.
    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"``; params and calib move to it.  ``clock`` (default
    ``time.monotonic``) stamps every latency mark (DESIGN.md §11).

    ``prefill_chunk`` (DESIGN.md §7) switches admission to chunked
    prefill: one queued prompt at a time reserves a free slot and streams
    through the SKVQ cache in chunks of at most ``prefill_chunk`` tokens,
    each padded to a ``chunk_buckets`` size (default: the halving ladder
    :func:`default_chunk_buckets`), at most one chunk per ``step()``
    before the decode chunk, so a long prompt no longer stalls every
    active stream for its whole prefill.  The caches and the workspace of
    one job are recycled for the next.  With a pool, the job's prefix
    keys are registered only once its blocks are on the device.

    ``pool_blocks`` switches the packed planes to shared paged pools of
    that many ``pool_block_tokens``-token blocks, one per quantized band
    (DESIGN.md §9); it needs ``pool_block_tokens >= 8``, the dense family
    and, in every quantized band, a packed capacity ``max_len - n_sink -
    window`` that is a multiple of ``pool_block_tokens``.
    ``pool_memory_bytes`` sizes the pools from a byte budget instead (an
    explicit ``pool_blocks`` overrides it, with a warning).  ``stats()``
    reports occupancy, prefix hit rate, copy-on-write copies and resident
    bytes, summed and per band; ``check_invariants()`` audits every band's
    pool after a drain.

    ``async_host`` delivers tokens on the background host loop (DESIGN.md
    §10): the scheduler decides eos/length finishes from the device's
    per-slot ``done``/``bad``/``live`` flags, and each chunk's tokens ride
    a bounded queue (``host_queue`` items) to the consumer thread in a
    ring of ``host_queue + 1`` host buffers (pinned on CUDA).  Streams are
    bit-identical to the synchronous loop; :meth:`run` drains, and
    :meth:`drain`/:meth:`close` are the graceful-shutdown calls.

    :meth:`warmup` (DESIGN.md §10) prepares the engine before traffic:
    kernel libraries loaded, caches allocated, one decode step captured
    as a CUDA graph that every later chunk replays, one throwaway request
    rehearsed, every counter restored; ``warmup_report()`` accounts for it.

    The degradation ladder (DESIGN.md §11): ``host_spill_bytes`` (pooled
    engines only) bounds the LRU host tier that cold registered blocks
    spill to; ``faults`` is a
    :class:`~repro_torch.serving.faults.FaultInjector` (off during
    warmup); ``step_timeout_s`` arms the watchdog, which sheds every
    stream after ``watchdog_max_trips`` consecutive chunks over it (wall
    time, device work included, plus any injected delay); ``detokenize``
    (``tokens -> str``) grows ``handle.text``.  ``stats()["counters"]``
    counts preemptions, spilled and restored blocks, deadline misses,
    cancels, sheds, NaN quarantines and watchdog trips, and
    ``stats()["host_spill"]`` the tier; ``check_invariants()`` audits the
    tier with the pools.
    """

    def __init__(self, params, cfg: ArchConfig, policy, batch_slots: int,
                 max_len: int, calib=None, seed: int = 0, backend=None,
                 steps_per_sync: int = 8, dtype=None,
                 prefill_chunk: Optional[int] = None, chunk_buckets=None,
                 pool_blocks: Optional[int] = None,
                 pool_block_tokens: int = 16,
                 pool_memory_bytes: Optional[int] = None,
                 async_host: bool = False, host_queue: int = 8,
                 detokenize: Optional[Callable] = None,
                 host_spill_bytes: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 faults=None, step_timeout_s: Optional[float] = None,
                 watchdog_max_trips: int = 2, device=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if prefill_chunk is None and chunk_buckets is not None:
            raise ValueError("chunk_buckets requires prefill_chunk to be set")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, "
                                 f"got {prefill_chunk}")
            T._check_chunkable(cfg)       # fail at build time, not mid-serve
            if chunk_buckets is None:
                chunk_buckets = default_chunk_buckets(prefill_chunk)
            chunk_buckets = tuple(sorted(int(b) for b in chunk_buckets))
            if not chunk_buckets or chunk_buckets[-1] != prefill_chunk:
                raise ValueError(
                    f"chunk_buckets {chunk_buckets} must be non-empty and "
                    f"its largest entry must equal prefill_chunk "
                    f"({prefill_chunk})")
            if chunk_buckets[0] < 1:
                raise ValueError(f"chunk_buckets entries must be >= 1, "
                                 f"got {chunk_buckets}")
        self.prefill_chunk = prefill_chunk
        self.chunk_buckets = chunk_buckets
        self._prefill_job: Optional[_PrefillJob] = None
        self._chunk_state: Optional[Dict] = None  # recycled between jobs
        self._chunk_shapes: set = set()           # buckets run so far
        self.device = resolve_device(device)
        self.cfg = cfg
        self.schedule = as_schedule(policy, cfg.n_layers)
        # a bare policy comes back as given; anything else as the
        # materialized schedule (DESIGN.md §8)
        self.policy = policy if isinstance(policy, QuantPolicy) \
            else self.schedule
        T._check_calib_schedule(calib, self.schedule, cfg)
        self.params = _to(T._cast_params(params, dtype), self.device)
        self.calib = None if calib is None else _to(calib, self.device)
        self.backend = bk.resolve_backend(backend, self.device)
        self.max_len = max_len
        self.seed = seed
        self.steps_per_sync = max(1, steps_per_sync)
        self.batch_slots = batch_slots
        self._clock = clock if clock is not None else time.monotonic

        b = batch_slots
        self._slot_handle: List[Optional[StreamHandle]] = [None] * b
        self._tok = np.zeros((b, 1), np.int64)
        self._done = np.ones((b,), bool)          # free slots ride as "done"
        self._temps = np.zeros((b,), np.float32)
        self._eos = np.full((b,), -1, np.int64)
        self._gens: List[Optional[torch.Generator]] = [None] * b
        self._queue: List[StreamHandle] = []
        self._caches = None                       # allocated at 1st admission
        self._next_rid = 0
        self.n_decode_steps = 0                   # decode steps run (all slots)
        self._tick = 0
        self._last_stall_tick = -1                # one stall count per tick
        self._counters = {"admitted": 0, "queue_wait_ticks": 0,
                          "pool_exhausted_stalls": 0, "preemptions": 0,
                          "spilled_blocks": 0, "restored_blocks": 0,
                          "deadline_misses": 0, "cancelled": 0, "shed": 0,
                          "nan_quarantines": 0, "watchdog_trips": 0}

        # ----- degradation ladder + fault model (DESIGN.md §11) -----
        if step_timeout_s is not None and step_timeout_s <= 0:
            raise ValueError(f"step_timeout_s must be > 0, "
                             f"got {step_timeout_s}")
        if watchdog_max_trips < 1:
            raise ValueError(f"watchdog_max_trips must be >= 1, "
                             f"got {watchdog_max_trips}")
        self._faults = faults
        self.step_timeout_s = step_timeout_s
        self.watchdog_max_trips = int(watchdog_max_trips)
        self._watchdog_consec = 0
        self._wedged = False
        self._admit_seq = 0               # activation order, for victims
        self._slot_seq = np.zeros((b,), np.int64)
        self._nan_inject = np.zeros((b,), bool)
        self._nan_dev: Optional[torch.Tensor] = None  # static (B,) guard
        # slot -> {(group, bkey): [(phys, key, arrays)]} restored at
        # activation, before the pool insert
        self._pending_restore: Dict[int, dict] = {}
        self._spill: Optional[HostSpillTier] = (
            HostSpillTier(host_spill_bytes) if host_spill_bytes else None)
        self._evicted: List[tuple] = []   # (group, bkey, key, phys) to spill
        self._stage: Optional[torch.Tensor] = None   # pinned spill staging

        # ----- warmup graph cache + async host loop (DESIGN.md §10) -----
        self._graphs = GraphCache(self.device, clock=self._clock)
        self._unif: Optional[torch.Tensor] = None  # static (B, V) uniforms
        self._warm_s: Dict[str, Optional[float]] = {
            "build_s": None, "prefill_s": None, "rehearse_s": None}
        self._detok = detokenize
        self._host: Optional[HostLoop] = HostLoop(
            self._finish, detokenize, max_queue=host_queue,
            fault_hook=getattr(faults, "on_consume", None),
            clock=self._clock) if async_host else None
        self._ring: List[torch.Tensor] = []     # async token buffers
        self._ring_free: List[threading.Event] = []
        self._ring_next = 0

        # ----- paged block pool (DESIGN.md §9): one pool per quantized band
        self.pool_blocks = pool_blocks
        self.pool_block_tokens = int(pool_block_tokens)
        self._pools: Dict[tuple, BlockPool] = {}   # (group, bkey) -> pool
        self._pool_bands: List[tuple] = []  # (group, bkey, bs, be, pol, nb)
        # slot -> {(group, bkey): miss pairs}
        self._pending_insert: Dict[int, dict] = {}
        # slot -> {(group, bkey): (key, phys)} of a chunked job, registered
        # once its blocks are on the device
        self._pending_register: Dict[int, dict] = {}
        self._hostlen = np.zeros((b,), np.int64)    # device length mirror
        self._stall_reason: Optional[str] = None
        if pool_blocks is None and pool_memory_bytes is not None:
            self.pool_blocks = self._size_pool_blocks(pool_memory_bytes)
        elif pool_blocks is not None and pool_memory_bytes is not None:
            warnings.warn(
                f"explicit pool_blocks={pool_blocks} overrides "
                f"pool_memory_bytes={pool_memory_bytes}", stacklevel=2)
        if self.pool_blocks is not None:
            self._init_pool()
        if self._spill is not None and not self._pools:
            raise ValueError(
                "host_spill_bytes requires the paged block pool "
                "(set pool_blocks or pool_memory_bytes): only pooled "
                "packed blocks spill to host RAM — DESIGN.md §11")
        # after the option checks, so that a pooled or chunked encdec
        # engine meets the reference's refusal of its option first
        check_servable(cfg)

    # ------------------------------------------------------ pool set-up (§9)

    def _enumerate_pool_bands(self) -> List[tuple]:
        """Quantized bands with a packed region to pool, with their block
        bytes: ``(group, bkey, bs, be, pol, nb, nbytes)`` rows, validated
        once here (DESIGN.md §9; the ``pool_memory_bytes`` sizing of §10
        reads them too).  fp16 bands, and bands whose window and sinks
        cover ``max_len``, stay striped."""
        cfg, bt = self.cfg, self.pool_block_tokens
        if bt < 8:
            raise ValueError(f"pool_block_tokens must be >= 8, got {bt}")
        if cfg.family != "dense":
            raise ValueError(
                f"the paged KV block pool supports the dense family only "
                f"(the scan-family recurrence has no packed planes to "
                f"pool), got family={cfg.family!r}")
        rows: List[tuple] = []
        for bs, be, pol in self.schedule.bands():
            if pol.is_fp16:
                continue
            sq = max(0, self.max_len - pol.n_sink - pol.window)
            if sq == 0:
                continue
            if sq % bt:
                raise ValueError(
                    f"band L{bs:03d} packed capacity {sq} (max_len="
                    f"{self.max_len} - n_sink={pol.n_sink} - window="
                    f"{pol.window}) is not a multiple of pool_block_tokens="
                    f"{bt}; choose max_len so every quantized band's packed "
                    f"region tiles into whole pool blocks")
            nbytes = kvc.pool_block_nbytes(cfg.n_kv_heads, cfg.head_dim,
                                           pol, bt) * (be - bs)
            rows.append(("scan", T._band_key(bs), bs, be, pol, sq // bt,
                         nbytes))
        if not rows:
            raise ValueError(
                "pool_blocks was set but there is no packed region to pool "
                "(every band is fp16 or its window+sinks cover max_len); "
                "drop pool_blocks to serve striped")
        return rows

    def _size_pool_blocks(self, budget: int) -> int:
        """Blocks per band affordable under a ``pool_memory_bytes`` budget
        (DESIGN.md §10): the budget over the summed per-band block bytes
        (every band's pool holds the same count), warning when the
        division leaves a remainder."""
        if budget < 1:
            raise ValueError(f"pool_memory_bytes must be >= 1, got {budget}")
        per_block = sum(r[6] for r in self._enumerate_pool_bands())
        blocks = budget // per_block
        if blocks < 1:
            raise ValueError(
                f"pool_memory_bytes={budget} cannot fit a single pool "
                f"block: one block across all quantized bands costs "
                f"{per_block} bytes; raise the budget or coarsen the policy")
        waste = budget - blocks * per_block
        if waste:
            warnings.warn(
                f"pool_memory_bytes={budget} rounds down to "
                f"pool_blocks={blocks} ({per_block} bytes/block across "
                f"bands; {waste} bytes of the budget unusable)",
                stacklevel=3)
        return int(blocks)

    def _init_pool(self):
        if self.pool_blocks < 1:
            raise ValueError(f"pool_blocks must be >= 1, "
                             f"got {self.pool_blocks}")
        self._pools, self._pool_bands = {}, []
        for group, bkey, bs, be, pol, nb, nbytes in \
                self._enumerate_pool_bands():
            pool = BlockPool(self.pool_blocks, self.batch_slots, nb,
                             block_nbytes=nbytes)
            if self._spill is not None:
                pool.on_evict = functools.partial(self._note_evict, group,
                                                  bkey)
            self._pools[(group, bkey)] = pool
            self._pool_bands.append((group, bkey, bs, be, pol, nb))

    # ------------------------------------------------------------ public API

    @property
    def backend_info(self) -> dict:
        """Backend, policy and device facts (DESIGN.md §4) and the
        schedule's accounting (DESIGN.md §8): per-layer avg-bits and cache
        bytes per slot at ``max_len``, and the pools' bytes per band."""
        cfg, sched = self.cfg, self.schedule
        layer_bytes = kvc.schedule_cache_nbytes(
            sched, cfg.n_layers, self.max_len, cfg.n_kv_heads, cfg.head_dim,
            dtype=self.params["embed"].dtype)
        out = dict(self.backend.info())
        out.update({"device": str(self.device), "policy": self.policy,
                    "batch_slots": self.batch_slots, "max_len": self.max_len,
                    "steps_per_sync": self.steps_per_sync,
                    "schedule_uniform": sched.is_uniform,
                    "n_policies": len(sched.distinct()),
                    "avg_bits": sched.avg_bits(cfg.head_dim),
                    "layer_avg_bits": sched.layer_avg_bits(cfg.head_dim),
                    "layer_cache_bytes": layer_bytes,
                    "cache_bytes_per_slot": sum(layer_bytes),
                    "pooled": bool(self._pools)})
        if self._pools:
            out.update({"pool_blocks": self.pool_blocks,
                        "pool_block_tokens": self.pool_block_tokens,
                        "pool_bands": {f"{g}/{k}": p.block_nbytes
                                       for (g, k), p in self._pools.items()},
                        "pool_bytes": sum(self.pool_blocks * p.block_nbytes
                                          for p in self._pools.values())})
        return out

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (DESIGN.md §6)."""
        return len(self._queue)

    @property
    def active_slots(self) -> int:
        """Slots holding a request (DESIGN.md §6)."""
        return sum(h is not None for h in self._slot_handle)

    @property
    def prefill_shapes(self) -> tuple:
        """Chunk buckets run so far (chunked-prefill mode; DESIGN.md §7):
        always a subset of ``chunk_buckets``, however ragged the
        traffic."""
        return tuple(sorted(self._chunk_shapes))

    def now(self) -> float:
        """Current engine time from the injectable clock (DESIGN.md §11):
        what external callers (the load generator, metrics recorders)
        anchor on, so their marks compare with the handles'."""
        return self._clock()

    def drain(self) -> None:
        """Block until the async host loop has delivered every enqueued
        chunk (a no-op for the synchronous engine; DESIGN.md §10)."""
        if self._host is not None:
            self._host.drain()

    def close(self, drain: bool = True) -> None:
        """Shut down the async host loop thread, draining first by default
        (DESIGN.md §10).  The engine stays usable: the next async delivery
        restarts the thread."""
        if self._host is not None:
            self._host.close(drain=drain)

    # ------------------------------------------------- warmup (DESIGN.md §10)

    def warmup(self, prompt_lens: Optional[Sequence[int]] = None,
               rehearse: bool = True) -> dict:
        """Prepare the engine before traffic (DESIGN.md §10) and return
        :meth:`warmup_report`.

        1. Load (building first if needed) both kernel libraries: the nvcc
           build is the counterpart of AOT compilation, and a first-use
           build or ``ctypes`` load cannot happen inside a capture.
        2. Allocate the engine caches from shapes, as first admission
           would, and capture ONE decode step (:func:`decode_one` on those
           caches, striped or pooled) as a CUDA graph; every later chunk
           replays it ``steps_per_sync`` times.
        3. Whole-prompt mode: one throwaway batch-of-1 prefill per
           ``prompt_lens`` entry (PyTorch compiles nothing per shape, but
           cuBLAS and the allocator settle at first use).  Chunked mode
           (DESIGN.md §7): one throwaway chunk per ``chunk_buckets`` entry
           on the recycled prefill state, which is then zeroed;
           ``prompt_lens`` is not needed.
        4. ``rehearse``: a throwaway request (one per chunk bucket in
           chunked mode) through the real scheduler (prefill, admission,
           one replayed chunk, retirement).

        The capture's warmup iterations and the rehearsal really run on
        the caches, so after each the caches are zeroed in place and the
        pool, every counter and the host loop's accounting start afresh.
        Warmup refuses to run while a request is queued or active.  On
        the CPU (tests) nothing is captured and the decode loop runs the
        same per-step path with the step run eagerly."""
        if self._queue or self.active_slots:
            raise RuntimeError("warmup() cannot run while requests are "
                               "queued or active: it captures on the "
                               "engine's own cache buffers and then zeroes "
                               "them")
        t0 = self._clock()
        if self.device.type == "cuda" and self.backend.info().get("kernels"):
            from ..kernels import _build
            for name in _build.SOURCES:
                _build.load(name)
        self._warm_s["build_s"] = self._clock() - t0
        if self._caches is None:
            self._caches = self._alloc_caches()
        b, dev = self.batch_slots, self.device
        if self._unif is None:
            self._unif = torch.zeros((b, self.cfg.vocab_size),
                                     dtype=torch.float32, device=dev)
            self._nan_dev = torch.zeros((b,), dtype=torch.bool, device=dev)
        static = (torch.zeros((b, 1), dtype=torch.int64, device=dev),
                  torch.ones((b,), dtype=torch.bool, device=dev),
                  torch.zeros((b,), dtype=torch.bool, device=dev),
                  torch.zeros((b,), dtype=torch.int32, device=dev),
                  torch.zeros((b,), dtype=torch.float32, device=dev),
                  torch.full((b,), -1, dtype=torch.int64, device=dev),
                  self._unif, self._nan_dev)
        self._graphs.warm("decode_step", self._step, static)
        self._restore()
        t0 = self._clock()
        if self.prefill_chunk is not None:
            st = self._take_chunk_state()
            for bucket in self.chunk_buckets:
                self._run_chunk(st, np.zeros(bucket, np.int64), 0,
                                min(bucket, self.max_len))
            self._chunk_state = st        # zeroed when the next job takes it
        else:
            for plen in prompt_lens or ():
                T.prefill_model(
                    self.params, self.cfg,
                    torch.zeros((1, int(plen)), dtype=torch.int64,
                                device=dev),
                    self.schedule, calib=self.calib, max_len=self.max_len,
                    backend=self.backend)
        self._warm_s["prefill_s"] = self._clock() - t0
        if rehearse:
            t0 = self._clock()
            faults, self._faults = self._faults, None   # no chaos in warmup
            try:
                self._rehearse()
            finally:
                self._faults = faults
            self._restore()
            self._warm_s["rehearse_s"] = self._clock() - t0
        self._graphs.warmed = True
        return self.warmup_report()

    def warmup_report(self) -> dict:
        """Warmup accounting (DESIGN.md §10): kernel load/build seconds,
        graphs captured and capture seconds, prompt-length prefill and
        rehearsal seconds, replays, and ``post_warmup_misses`` — calls that
        found no graph after :meth:`warmup`, whose contract is 0."""
        out = self._graphs.report()
        out.update(self._warm_s)
        return out

    def _rehearse(self):
        """Run tiny requests through the real scheduler (DESIGN.md §10):
        one, or one per chunk bucket in chunked mode."""
        if self.chunk_buckets is not None:
            lens = [b for b in self.chunk_buckets if b + 2 <= self.max_len]
        else:
            lens = [p for p in (min(8, self.max_len - 2),) if p >= 1]
        handles = []
        for plen in lens:
            prompt = (np.arange(plen, dtype=np.int64) % 17) + 1
            try:
                handles.append(self.submit(Request(
                    prompt=prompt, max_new=2, seed=0x7FFF0000)))
            except ValueError:
                continue          # e.g. a pool too small: nothing to run
        if handles:
            self.run(handles)

    def _restore(self):
        """Zero the caches in place (the graph is bound to them) and start
        the pool, the host spill tier (the rehearsal's spills do not
        count), every counter and the host loop's accounting afresh."""
        _zero(self._caches)
        if self._spill is not None:
            self._spill = HostSpillTier(self._spill.budget_bytes)
        if self._pools:
            self._init_pool()     # fresh free lists, registries, counters
        self._next_rid = 0
        self._tick = 0
        self._last_stall_tick = -1
        self._watchdog_consec = 0
        self._wedged = False
        self._nan_inject[:] = False
        self._pending_restore.clear()
        self._evicted.clear()
        self._stall_reason = None
        self.n_decode_steps = 0
        self._graphs.replays = 0
        self._tok[:] = 0
        self._hostlen[:] = 0
        self._pending_register.clear()
        for k in self._counters:
            self._counters[k] = 0
        if self._host is not None:
            self._host.enqueued = self._host.delivered = 0
            self._host.backpressure_waits = 0
            self._host.backpressure_s = 0.0
            self._host.max_depth = 0

    def submit(self, request: Request) -> StreamHandle:
        """Validate + queue a request; returns its handle (DESIGN.md §6)."""
        prompt = np.asarray(request.prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("Request.prompt must be a non-empty 1-D "
                             "sequence of token ids")
        if request.max_new < 1:
            raise ValueError(f"Request.max_new must be >= 1, "
                             f"got {request.max_new}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"Request.prompt token ids must lie in "
                             f"[0, {self.cfg.vocab_size})")
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            raise ValueError(f"Request.deadline_ms must be > 0 (or None "
                             f"for no deadline), got {request.deadline_ms}")
        if request.priority != int(request.priority):
            raise ValueError(f"Request.priority must be an integer, "
                             f"got {request.priority!r}")
        if prompt.size + request.max_new > self.max_len:
            raise ValueError(
                f"Request.prompt length ({prompt.size}) + Request.max_new "
                f"({request.max_new}) exceeds the engine's per-slot cache "
                f"capacity max_len={self.max_len}")
        for group, bkey, bs, be, pol, nb in self._pool_bands:
            need = self._eventual_blocks(prompt.size, request.max_new, pol,
                                         nb)
            if need > self.pool_blocks:
                st = self._pools[(group, bkey)].stats()
                raise ValueError(
                    f"Request needs up to {need} pool blocks in band "
                    f"{bkey} ({group}) but the engine's pool only has "
                    f"pool_blocks={self.pool_blocks} "
                    f"({st['used']} used, {st['free']} free, "
                    f"{st['reserved']} reserved); raise pool_blocks or "
                    f"shorten the request — it could never be admitted")
        request = dataclasses.replace(request, prompt=prompt)
        handle = StreamHandle(request, self._next_rid, now=self._clock())
        handle._t_submit = handle.submit_time   # deadline epoch
        self._next_rid += 1
        self._queue.append(handle)
        return handle

    def step(self) -> bool:
        """One scheduler tick: faults -> lifecycle -> retire -> admit ->
        [one prefill chunk] -> one decode chunk (DESIGN.md §6, §7, §11).
        In chunked mode at most one prefill chunk runs a tick, before the
        decode chunk of the active slots.  False when there is nothing left
        to do or the watchdog shed everything; a queue that waits for pool
        blocks (pressure or seized blocks), or a prefill in flight, keeps
        returning True."""
        self._tick += 1
        tick = getattr(self._clock, "tick", None)
        if callable(tick):
            tick()                        # deterministic virtual clocks
        if self._faults is not None:
            self._faults.on_tick(self)
        self._lifecycle()
        self._retire()
        self._admit()
        self._counters["queue_wait_ticks"] += len(self._queue)
        self._prefill_tick()
        active = [i for i in range(self.batch_slots)
                  if self._slot_handle[i] is not None]
        if not active:
            return self._prefill_job is not None or bool(self._queue)
        if any(not self._h_done(self._slot_handle[i]) for i in active):
            self._decode_chunk()
            if self._wedged:
                self._shed_all()          # watchdog abort: end every stream
                return False
        self._retire()
        return True

    def run(self, handles: Optional[List[StreamHandle]] = None) -> None:
        """Step until the given handles (default: everything) finish, then
        drain the async host loop so every stream is final (DESIGN.md §6,
        §10)."""
        def pending():
            if handles is not None:
                return any(not self._h_done(h) for h in handles)
            return (bool(self._queue) or self._prefill_job is not None
                    or any(h is not None for h in self._slot_handle))

        while pending():
            if not self.step():
                break
        self.drain()

    def stats(self) -> dict:
        """Pool occupancy + sharing counters (DESIGN.md §9), summed over the
        quantized bands and per band under ``bands``: blocks used/free/
        reserved, prefix hit rate, copy-on-write copies, resident and peak
        packed bytes against the striped worst case (``batch_slots`` full
        stripes), and the cumulative ``counters`` of DESIGN.md §10
        (requests admitted, request-ticks spent queued, ticks the FIFO head
        stalled on an exhausted pool, CoW copies; restored by
        :meth:`warmup`), plus the async host loop's ``host`` block.  A
        striped engine reports only the queue, the counters and ``host``."""
        out: dict = {"pooled": bool(self._pools),
                     "queue_depth": len(self._queue),
                     "active_slots": self.active_slots,
                     "counters": dict(self._counters, cow_copies=sum(
                         p.cow_copies for p in self._pools.values()))}
        if self._host is not None:
            out["host"] = self._host.stats()
        if self._spill is not None:
            out["host_spill"] = self._spill.stats()
        if not self._pools:
            return out
        bands = {}
        agg = {k: 0 for k in ("blocks", "used", "free", "reserved",
                              "peak_used", "prefix_hits", "prefix_misses",
                              "cow_copies", "resident_bytes")}
        striped_worst = peak_bytes = 0
        for group, bkey, bs, be, pol, nb in self._pool_bands:
            pool = self._pools[(group, bkey)]
            st = pool.stats()
            st["n_table"] = nb
            bands[f"{group}/{bkey}"] = st
            for k in agg:
                agg[k] += st[k]
            striped_worst += self.batch_slots * nb * pool.block_nbytes
            peak_bytes += pool.peak_used * pool.block_nbytes
        h, m = agg["prefix_hits"], agg["prefix_misses"]
        out.update(agg)
        out.update({
            "prefix_hit_rate": h / (h + m) if h + m else 0.0,
            "peak_resident_bytes": peak_bytes,
            "striped_worst_case_bytes": striped_worst,
            "pool_blocks": self.pool_blocks,
            "pool_block_tokens": self.pool_block_tokens,
            "bands": bands})
        if self._stall_reason:
            out["admission_stall"] = self._stall_reason
        return out

    def check_invariants(self) -> dict:
        """Leak/consistency audit after a drain (DESIGN.md §11): every
        band's pool (refcounts, free list, tables, seized holds,
        reservations and registry; :meth:`BlockPool.check_invariants`),
        keyed ``"group/bkey"``, and the host spill tier's byte accounting
        under ``"host_spill"``.  Raises ``RuntimeError`` on the first
        violation; ``{}`` for a striped engine."""
        out = {f"{group}/{bkey}": pool.check_invariants()
               for (group, bkey), pool in self._pools.items()}
        if self._spill is not None:
            self._spill.check_invariants()
            out["host_spill"] = self._spill.stats()
        return out

    # --------------------------------------------------------------- details

    def _h_done(self, h: StreamHandle) -> bool:
        # async: the scheduler's verdict stands in for h.finished, which
        # the consumer thread sets later, at delivery (DESIGN.md §10)
        if self._host is not None:
            return h._sched_fin is not None
        return h.finished

    def _retire(self):
        for i, h in enumerate(self._slot_handle):
            if h is not None and self._h_done(h):
                self._release_slot(i)

    def _release_slot(self, i: int):
        """Free lane ``i``: pool blocks deref (cold registered ones spill to
        the host tier when it is on, DESIGN.md §11), pending insert,
        register and restore state drops (un-applied restores go back to
        the tier), host mirrors clear and the device row zeroes.  Shared by
        retirement, preemption, cancellation, deadline expiry and the
        watchdog abort."""
        self._slot_handle[i] = None
        self._done[i] = True
        self._eos[i] = -1
        self._temps[i] = 0.0
        self._gens[i] = None
        self._nan_inject[i] = False
        self._pending_insert.pop(i, None)
        self._pending_register.pop(i, None)
        for rest in self._pending_restore.pop(i, {}).values():
            for phys, key, arrays in rest:
                self._spill.put(key, arrays,
                                sum(a.nbytes for a in arrays.values()))
        for pool in self._pools.values():
            pool.release_slot(i)          # deref blocks; shared ones live on
        self._spill_evicted()
        self._hostlen[i] = 0
        if self._caches is not None:
            kvc.reset_slot(self._caches, i, batch_axis=1)

    # ------------------------------------- lifecycle + degradation (§11)

    def _expired(self, h: StreamHandle, now: float) -> bool:
        dl = h.request.deadline_ms
        return (dl is not None and h._t_submit is not None
                and (now - h._t_submit) * 1e3 > dl)

    def _finish_now(self, h: StreamHandle, reason: str):
        """End a stream outside the token path (deadline, cancel, shed;
        DESIGN.md §11).  An async engine sends the verdict through the host
        loop as a zero-token delivery (no ring buffer to release), so the
        consumer thread stays the one writer of a stream, in FIFO order."""
        if self._host is not None:
            h._sched_fin = reason
            self._host.put(TokenDelivery(
                handles=[h], rows=[0], counts=[0], reasons=[reason],
                tokens=np.zeros((1, 1), np.int64)))
        else:
            self._finish(h, reason)

    def _end_for(self, h: StreamHandle):
        """Cancel or deadline verdict of a stream leaving early, counted."""
        if h._cancel:
            self._counters["cancelled"] += 1
            self._finish_now(h, FinishReason.CANCELLED)
        else:
            self._counters["deadline_misses"] += 1
            self._finish_now(h, FinishReason.DEADLINE)

    def _lifecycle(self):
        """Deadline/cancel pass, once a tick (DESIGN.md §11): cancelled or
        expired requests end with their FinishReason and free their pool
        blocks at once; queued ones never take a slot."""
        now = self._clock()
        keep = []
        for h in self._queue:
            if h._cancel or self._expired(h, now):
                self._end_for(h)
            else:
                keep.append(h)
        self._queue = keep
        job = self._prefill_job
        if job is not None and (job.handle._cancel
                                or self._expired(job.handle, now)):
            self._end_for(job.handle)
            self._prefill_job = None
            self._chunk_state = job.state     # recycle the prefill buffers
            self._release_slot(job.slot)
        for i, h in enumerate(self._slot_handle):
            if h is None or self._h_done(h):
                continue
            if h._cancel or self._expired(h, now):
                self._end_for(h)
                self._release_slot(i)

    def _pick_victim(self, req: Request) -> Optional[int]:
        """Victim policy (DESIGN.md §11): only slots of *strictly lower*
        priority than the candidate are preemptible (equal priorities wait
        FIFO: mutual eviction would livelock); lowest priority first, and
        within a priority the last admitted (the least sunk work)."""
        best = None
        for i, h in enumerate(self._slot_handle):
            if h is None or self._h_done(h):
                continue
            if h.request.priority >= req.priority:
                continue
            rank = (h.request.priority, -int(self._slot_seq[i]))
            if best is None or rank < best[0]:
                best = (rank, i)
        return None if best is None else best[1]

    def _preempt_slot(self, i: int):
        """Evict slot ``i`` back to the queue for recompute-from-prompt
        (DESIGN.md §11).  Delivered tokens stay on the handle; the resumed
        stream regenerates them (greedy, or a fresh generator from the same
        seeds) and the replay filter asserts the prefix matches before
        anything new is appended.  The slot's registered blocks spill to
        the host tier on release, so the resume can restore them.  An async
        engine drains its host loop first, so no delivery of the slot's
        earlier chunks is still in flight when the replay state resets."""
        h = self._slot_handle[i]
        if self._host is not None:
            self._host.drain()
        committed = (h._sched_consumed if self._host is not None
                     else len(h.tokens))
        h._replay_len = max(h._replay_len, committed)
        h._replay_cursor = 0
        h._sched_consumed = 0
        h._sched_fin = None
        h.preempted += 1
        h.events.append(FinishReason.PREEMPTED)
        self._counters["preemptions"] += 1
        self._release_slot(i)
        self._queue.append(h)   # re-sorted by (-priority, rid) at admission

    def _plan_with_preemption(self, req: Request):
        """Admission plan for the queue head, evicting strictly-lower
        priority victims one at a time until it fits or none is left
        (DESIGN.md §11)."""
        plan = self._plan_pool_admission(req)
        while plan is None:
            victim = self._pick_victim(req)
            if victim is None:
                return None
            self._preempt_slot(victim)
            plan = self._plan_pool_admission(req)
        return plan

    def _shed_all(self):
        """Watchdog abort (DESIGN.md §11): the device step is declared
        wedged, so every queued and active stream ends ``shed`` (a valid
        FinishReason: ``run()`` returns instead of hanging) and every pool
        block frees."""
        job = self._prefill_job
        if job is not None:
            self._prefill_job = None
            self._chunk_state = job.state
            self._counters["shed"] += 1
            self._finish_now(job.handle, FinishReason.SHED)
            self._release_slot(job.slot)
        for i, h in enumerate(self._slot_handle):
            if h is None:
                continue
            if not self._h_done(h):
                self._counters["shed"] += 1
                self._finish_now(h, FinishReason.SHED)
            self._release_slot(i)
        for h in self._queue:
            self._counters["shed"] += 1
            self._finish_now(h, FinishReason.SHED)
        self._queue = []

    def _watchdog(self, dt: float):
        """Device-step watchdog (DESIGN.md §11): a decode chunk over
        ``step_timeout_s`` (its wall time, the host's wait for the device
        included, plus any injected delay) is a trip;
        ``watchdog_max_trips`` consecutive trips declare the device wedged
        and :meth:`step` sheds everything.  A healthy chunk resets the
        streak."""
        extra = (self._faults.take_step_delay()
                 if self._faults is not None else 0.0)
        if self.step_timeout_s is None:
            return
        if dt + extra > self.step_timeout_s:
            self._counters["watchdog_trips"] += 1
            self._watchdog_consec += 1
            if self._watchdog_consec >= self.watchdog_max_trips:
                self._wedged = True
        else:
            self._watchdog_consec = 0

    # --------------------------------------------- host spill tier (§11)

    def _note_evict(self, group: str, bkey: str, key: str, phys: int):
        """``BlockPool.on_evict``: a registered block just reached refcount
        0.  Its bytes are read off the device by :meth:`_spill_evicted`
        before anything can write the block again."""
        self._evicted.append((group, bkey, key, phys))

    def _spill_evicted(self):
        """Park the blocks a release just freed in the host tier, in the
        order their hooks fired (DESIGN.md §11): one gathered read per band
        (:func:`kv_cache.pool_read_blocks`, one device->host copy), then one
        tier entry per content key."""
        ev, self._evicted = self._evicted, []
        if not ev or self._spill is None or self._caches is None:
            return
        got = {}
        for band in dict.fromkeys((g, k) for g, k, _, _ in ev):
            phys = [p for g, k, _, p in ev if (g, k) == band]
            blocks = kvc.pool_read_blocks(_band(self._caches, *band), phys,
                                          pool_axis=1,
                                          stage=self._host_stage())
            got[band] = iter(blocks)
        for group, bkey, key, _ in ev:
            arrays = next(got[(group, bkey)])
            if self._spill.put(key, arrays,
                               sum(a.nbytes for a in arrays.values())):
                self._counters["spilled_blocks"] += 1

    def _admit(self):
        """Move queued requests toward decode slots (DESIGN.md §6, §11).
        The queue orders by (priority desc, rid asc), FIFO within a
        priority.  Whole-prompt admission: equal prompt lengths prefill as
        one batch, distinct lengths batch-of-1, no cross-slot padding.
        Chunked admission reserves a free slot for one job at a time.  With
        a pool (§9) admission is FIFO in blocks: the head is admitted only
        when every band covers its prompt blocks (minus resident prefix
        hits) plus its decode reservation, and under pressure it may
        preempt strictly-lower-priority slots (§11)."""
        if len(self._queue) > 1:
            self._queue.sort(key=lambda h: (-h.request.priority, h.rid))
        job = self._prefill_job
        free = [i for i in range(self.batch_slots)
                if self._slot_handle[i] is None
                and not (job is not None and job.slot == i)]
        if not free or not self._queue:
            return
        if self.prefill_chunk is not None:
            if job is not None:
                return                    # one chunked job at a time
            if self._pools:
                self._stall_reason = None
                plan = self._plan_with_preemption(self._queue[0].request)
                if plan is None:
                    self._note_stall()          # FIFO: the head waits
                    return
                # the content lands at _finish_prefill: defer registration
                self._commit_pool_admission(free[0], plan, register=False)
            h = self._queue.pop(0)
            h.admit_time = self._clock()
            self._prefill_job = _PrefillJob(handle=h, slot=free[0], pos=0,
                                            state=self._take_chunk_state())
            return
        if self._pools:
            taken: List[tuple] = []
            self._stall_reason = None
            while self._queue and len(taken) < len(free):
                plan = self._plan_with_preemption(self._queue[0].request)
                if plan is None:
                    self._note_stall()          # FIFO: the head waits
                    break
                h, slot = self._queue.pop(0), free[len(taken)]
                self._commit_pool_admission(slot, plan)
                taken.append((h, slot))
            pgroups: Dict[int, List[tuple]] = {}
            for h, slot in taken:
                pgroups.setdefault(len(h.request.prompt), []).append((h, slot))
            for pairs in pgroups.values():
                self._admit_group([h for h, _ in pairs], [s for _, s in pairs])
            return
        take, self._queue = (self._queue[:len(free)],
                             self._queue[len(free):])
        groups: Dict[int, List[StreamHandle]] = {}
        for h in take:
            groups.setdefault(len(h.request.prompt), []).append(h)
        it = iter(free)
        for hs in groups.values():
            self._admit_group(hs, [next(it) for _ in hs])

    # ----------------------------------------------- paged block pool (§9)

    def _note_stall(self):
        """One stalled tick counts one ``pool_exhausted_stalls``."""
        if self._last_stall_tick != self._tick:
            self._last_stall_tick = self._tick
            self._counters["pool_exhausted_stalls"] += 1

    def _eventual_blocks(self, plen: int, max_new: int, pol, nb: int
                         ) -> int:
        """Worst-case pool blocks a request will ever hold in one band:
        every packed position its stream can reach, including up to
        ``steps_per_sync - 1`` clipped overshoot writes, all inside the
        band's ``nb``-block table."""
        bt = self.pool_block_tokens
        qc_end = min(max(0, plen + max_new + self.steps_per_sync
                         - pol.n_sink - pol.window), nb * bt)
        return -(-qc_end // bt)

    def _plan_pool_admission(self, req: Request):
        """Dry-run admission of one request: per band, the prefix-key
        lookups and the block budget.  None (with ``_stall_reason`` set) if
        any band lacks blocks; nothing is allocated before
        :meth:`_commit_pool_admission`."""
        plans = {}
        for group, bkey, bs, be, pol, nb in self._pool_bands:
            pool = self._pools[(group, bkey)]
            full_keys, tail_key = prefix_block_keys(
                req.prompt.tolist(), pol.n_sink, pol.window,
                self.pool_block_tokens, seed=f"{group}:{bkey}:{pol}")
            hits = [(lb, key, pool.lookup(key))
                    for lb, key in enumerate(full_keys)]
            n_hit = sum(1 for _, _, p in hits if p is not None)
            eventual = self._eventual_blocks(len(req.prompt), req.max_new,
                                             pol, nb)
            if eventual - n_hit > pool.available():
                st = pool.stats()
                self._stall_reason = (
                    f"queued: the head request needs {eventual - n_hit} "
                    f"blocks in band {bkey} ({group}) but only "
                    f"{pool.available()} are uncommitted ({st['used']}/"
                    f"{st['blocks']} used, {st['reserved']} reserved for "
                    f"in-flight decodes, {st['resident_bytes']} resident "
                    f"bytes)")
                return None
            tail_phys = pool.lookup(tail_key) if tail_key else None
            plans[(group, bkey)] = (hits, tail_key, tail_phys, eventual,
                                    n_hit)
        return plans

    def _commit_pool_admission(self, slot: int, plans,
                               register: bool = True):
        """Apply a plan, band by band: ref prefix hits, alloc misses into
        the slot's table, reserve the remaining decode blocks, register the
        miss keys and remember which blocks the prefill must insert.  With
        ``register=False`` (a chunked job, whose blocks are written only at
        its last chunk) the miss keys wait in ``_pending_register`` until
        :meth:`_apply_pool_insert`, so no admission takes a prefix hit on a
        block whose content is not on the device yet.

        A miss first asks the host spill tier (DESIGN.md §11): a spilled
        key restores its exact bytes into the fresh block instead of an
        insert from the prefill, counts as a prefix hit, and its host
        arrays are popped now (the LRU could drop them before the slot
        activates) and written at :meth:`_apply_pool_insert`."""
        pend, pend_reg, pend_res = {}, {}, {}
        for band, (hits, tail_key, tail_phys, eventual, n_hit) in \
                plans.items():
            pool = self._pools[band]
            miss_pairs, reg, restores = [], [], []

            def take(lb, key, pool=pool, miss_pairs=miss_pairs, reg=reg,
                     restores=restores):
                fresh = pool.alloc(slot)
                pool.assign(slot, lb, fresh)
                arrays = (self._spill.pop(key)
                          if self._spill is not None else None)
                if arrays is not None:
                    pool.hits += 1
                    restores.append((fresh, key, arrays))
                    self._counters["restored_blocks"] += 1
                else:
                    pool.misses += 1
                    miss_pairs.append((lb, fresh))
                reg.append((key, fresh))

            for lb, key, phys in hits:
                if phys is not None:
                    pool.ref(phys)
                    pool.assign(slot, lb, phys)
                    pool.hits += 1
                else:
                    take(lb, key)
            if tail_key is not None:
                if tail_phys is not None:
                    pool.ref(tail_phys)
                    pool.assign(slot, len(hits), tail_phys)
                    pool.hits += 1
                else:
                    take(len(hits), tail_key)
            # decode still needs (eventual - full hits - allocated now)
            # blocks; a shared tail counts: its first write goes CoW
            pool.set_reservation(slot, max(0, eventual - n_hit - len(reg)))
            if register:
                for key, phys in reg:
                    pool.register(key, phys)
            else:
                pend_reg[band] = reg
            pend[band] = miss_pairs
            if restores:
                pend_res[band] = restores
        if not register:
            self._pending_register[slot] = pend_reg
        self._pending_insert[slot] = pend
        if pend_res:
            self._pending_restore[slot] = pend_res

    def _apply_pool_insert(self, slot: int, src_caches, row: int):
        """Quantize-once commit, band by band: write the slot's restored
        blocks back from the host tier (DESIGN.md §11), copy its miss blocks
        from its freshly prefilled striped cache into the band's pool (hits
        are resident already and are never inserted again), then register
        any deferred prefix keys, now that their content is on the
        device.  Everything lands in place, in stream order, before the
        table flush and the next decode chunk read it."""
        pend = self._pending_insert.pop(slot, {})
        pend_reg = self._pending_register.pop(slot, {})
        self._restore_blocks(self._pending_restore.pop(slot, {}))
        for (group, bkey), pairs in pend.items():
            if pairs:
                kvc.pool_insert_blocks(
                    _band(self._caches, group, bkey),
                    _band(src_caches, group, bkey), pairs,
                    src_slot=row, pool_axis=1)
            for key, phys in pend_reg.get((group, bkey), ()):
                self._pools[(group, bkey)].register(key, phys)

    def _restore_blocks(self, restores: dict):
        """Write popped host-tier blocks into their fresh physical blocks,
        one host->device copy per band (:func:`kv_cache.pool_write_blocks`;
        DESIGN.md §11)."""
        for (group, bkey), rest in restores.items():
            kvc.pool_write_blocks(_band(self._caches, group, bkey),
                                  [a for _, _, a in rest],
                                  [p for p, _, _ in rest], pool_axis=1,
                                  stage=self._host_stage())

    def _host_stage(self) -> Optional[torch.Tensor]:
        """The pinned host buffer every spill read and restore write of a
        card stages through (None on the CPU): one table's worth of blocks
        of the widest band, the most one release or one activation moves,
        allocated at first use and reused, so no copy pays for page-locking
        or first touch."""
        if self._stage is None and self.device.type == "cuda":
            need = max(nb * kvc.pool_block_bytes(_band(self._caches, g, k),
                                                 pool_axis=1)
                       for g, k, _, _, _, nb in self._pool_bands)
            self._stage = torch.empty(need, dtype=torch.uint8,
                                      pin_memory=True)
        return self._stage

    def _cow_cap(self) -> int:
        # a span of sps tokens touches at most ceil((sps-1)/bt)+1 blocks
        # per slot; a fixed pair count keeps the copy one shape per engine
        sps, bt = self.steps_per_sync, self.pool_block_tokens
        return self.batch_slots * ((sps - 1 + bt - 1) // bt + 1)

    def _pool_prewrite(self):
        """Copy-on-write pass before a decode chunk, band by band: every
        packed block the next ``steps_per_sync`` ring evictions can touch
        becomes private to its slot.  Shared blocks are copied to fresh
        ones (drawing on the slot's reservation); private ones drop their
        prefix-hash key."""
        sps, bt = self.steps_per_sync, self.pool_block_tokens
        for group, bkey, bs, be, pol, nb in self._pool_bands:
            pool = self._pools[(group, bkey)]
            pairs = []
            for i in range(self.batch_slots):
                if self._slot_handle[i] is None:
                    continue
                u_lo = int(self._hostlen[i]) - pol.n_sink - pol.window
                for lb in seg.blocks_spanned(u_lo, u_lo + sps, bt, nb):
                    work = pool.ensure_writable(i, lb)
                    if work is not None and work[0] == "copy":
                        pairs.append((work[1], work[2]))
            if pairs:
                arr = np.zeros((self._cow_cap(), 2), np.int64)
                arr[:len(pairs)] = pairs
                kvc.pool_copy_block(_band(self._caches, group, bkey), arr,
                                    pool_axis=1)

    def _flush_tables(self):
        """Push each band's dirty host table to the device ``block_tbl``
        leaf of the band's layers.  Rows of slots with no request are
        masked to the null block, so a free-wheeling device row never
        writes a live block."""
        live = np.array([h is not None for h in self._slot_handle], np.int32)
        for group, bkey, bs, be, pol, nb in self._pool_bands:
            pool = self._pools[(group, bkey)]
            if not pool.dirty:
                continue
            tbl = torch.as_tensor(pool.tables * live[:, None],
                                  device=self.device)
            dst = _band(self._caches, group, bkey)["block_tbl"]
            dst.copy_(tbl[None].expand_as(dst))
            pool.dirty = False

    def _alloc_caches(self):
        """Zeroed engine caches of every band, built from shapes (DESIGN.md
        §10 warmup; first admission when not warmed): a pooled band's
        planes ``(L_band, NP+1, BT, H, W)`` beside ``block_tbl`` ``(L_band,
        B, NB)``, every other band striped ``(L_band, B, ...)`` with a
        hybrid config's ``ssm_conv``/``ssm_h`` state beside its planes
        (``insert_slot`` copies the leaves of these caches, so every leaf
        a prefill builds has to be here); flat for one band, band-keyed
        for several (DESIGN.md §8).  An ``ssm`` config's caches are its
        RWKV6 state, one flat stack over every layer whatever the
        schedule, as its prefill builds them."""
        cfg, dtype = self.cfg, self.params["embed"].dtype
        bands = ([(0, cfg.n_layers, self.schedule[0])] if cfg.attn_free
                 else self.schedule.bands())
        outs = {}
        for bs, be, pol in bands:
            bkey = T._band_key(bs)
            if ("scan", bkey) in self._pools:
                shapes = kvc.pooled_cache_shapes(
                    self.batch_slots, self.max_len, cfg.n_kv_heads,
                    cfg.head_dim, pol, self.pool_blocks,
                    self.pool_block_tokens, dtype)
            else:
                shapes = T.layer_cache_shapes(cfg, self.batch_slots,
                                              self.max_len, pol, dtype)
            outs[bkey] = {k: torch.zeros((be - bs,) + s, dtype=d,
                                         device=self.device)
                          for k, (s, d) in shapes.items()}
        return {"scan": T._band_out(outs, bands, 0)}

    def _generator(self, request_seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.seed * 1_000_003 + request_seed) % 2 ** 63)

    def _uniforms(self, gens, temps) -> Optional[torch.Tensor]:
        if not any(t > 0 for t in temps):
            return None
        v = self.cfg.vocab_size
        rows = [torch.rand(v, generator=g, device=self.device)
                if (g is not None and t > 0) else
                torch.zeros(v, device=self.device)
                for g, t in zip(gens, temps)]
        return torch.stack(rows)

    def _admit_group(self, handles: List[StreamHandle], slots: List[int]):
        prompts = np.stack([h.request.prompt for h in handles])
        logits, caches = T.prefill_model(
            self.params, self.cfg, torch.as_tensor(prompts, device=self.device),
            self.schedule, calib=self.calib, max_len=self.max_len,
            backend=self.backend)
        temps = [max(float(h.request.temperature), 0.0) for h in handles]
        gens = [self._generator(h.request.seed) for h in handles]
        first = sample_per_slot(
            logits[:, -1].to(torch.float32),
            torch.tensor(temps, dtype=torch.float32, device=self.device),
            self._uniforms(gens, temps)).cpu().numpy()
        if self._caches is None:
            self._caches = self._alloc_caches()
        now = self._clock()
        self._counters["admitted"] += len(handles)
        for row, (h, slot) in enumerate(zip(handles, slots)):
            kvc.insert_slot(self._caches, slot, caches, src_slot=row,
                            batch_axis=1)
            if self._pools:
                self._apply_pool_insert(slot, caches, row)
                self._hostlen[slot] = len(h.request.prompt)
            req = h.request
            self._activate(slot, h)
            self._tok[slot, 0] = first[row]
            self._temps[slot] = temps[row]
            self._gens[slot] = gens[row]
            self._eos[slot] = -1 if req.eos_id is None else req.eos_id
            self._done[slot] = (req.eos_id is not None
                                and int(first[row]) == req.eos_id)
            if h.admit_time is None:      # the first residency's mark
                h.admit_time = now
            self._admit_deliver(slot, h, int(first[row]))

    def _activate(self, slot: int, h: StreamHandle):
        """Seat ``h`` in ``slot``, stamped with its activation order (the
        victim policy's age, DESIGN.md §11)."""
        self._slot_handle[slot] = h
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1

    # ------------------------------------------- chunked prefill (§7)

    def _prefill_tick(self):
        """Advance the job in flight by one chunk (DESIGN.md §7): the
        smallest bucket that covers the rest of the prompt (capped at
        ``prefill_chunk``), the chunk padded up to it.  After the last
        chunk the reserved slot is activated (:meth:`_finish_prefill`)."""
        job = self._prefill_job
        if job is None:
            return
        prompt = job.handle.request.prompt
        n = min(self.prefill_chunk, len(prompt) - job.pos)
        bucket = next(b for b in self.chunk_buckets if b >= n)
        toks = np.zeros(bucket, np.int64)
        toks[:n] = prompt[job.pos:job.pos + n]
        logits = self._run_chunk(job.state, toks, job.pos, n)
        job.pos += n
        if job.pos >= len(prompt):
            self._prefill_job = None
            self._finish_prefill(job, logits)

    def _run_chunk(self, state, toks: np.ndarray, t0: int, n: int):
        """One eager ``prefill_chunk`` of the bucket-padded ``toks``."""
        self._chunk_shapes.add(len(toks))
        logits, _ = T.prefill_chunk(
            self.params, self.cfg,
            torch.as_tensor(toks[None], device=self.device), state,
            self.schedule, t0, n, calib=self.calib, backend=self.backend)
        return logits

    def _take_chunk_state(self) -> Dict:
        """Prefill state for a new job, recycling the last job's buffers:
        the caches are zeroed in place; the workspace is reused dirty,
        since causality keeps every read of it on rows the new prompt has
        already written (DESIGN.md §7)."""
        st, self._chunk_state = self._chunk_state, None
        if st is None:
            return T.prefill_chunk_init(
                self.cfg, self.schedule, self.max_len, self.max_len, batch=1,
                dtype=self.params["embed"].dtype, device=self.device)
        _zero(st["caches"])
        return st

    def _finish_prefill(self, job: _PrefillJob, logits):
        """Activate the reserved slot from a completed chunked prefill:
        sample the first token, insert the grown cache in place (the
        captured decode graph holds these addresses), insert the pool's
        miss blocks and register the deferred keys, then deliver."""
        h, slot = job.handle, job.slot
        req = h.request
        caches = job.state["caches"]          # (L, 1, ...); ws stays
        temp = max(float(req.temperature), 0.0)
        gen = self._generator(req.seed)
        first = int(sample_per_slot(
            logits[:, -1].to(torch.float32),
            torch.tensor([temp], dtype=torch.float32, device=self.device),
            self._uniforms([gen], [temp]))[0])
        if self._caches is None:
            self._caches = self._alloc_caches()
        kvc.insert_slot(self._caches, slot, caches, src_slot=0, batch_axis=1)
        if self._pools:
            self._apply_pool_insert(slot, caches, 0)
            self._hostlen[slot] = len(req.prompt)
            for pool in self._pools.values():
                pool.dirty = True         # unmask the slot's table rows
        self._chunk_state = job.state     # recycled by the next job
        self._counters["admitted"] += 1
        self._activate(slot, h)
        self._tok[slot, 0] = first
        self._temps[slot] = temp
        self._gens[slot] = gen
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._done[slot] = req.eos_id is not None and first == req.eos_id
        self._admit_deliver(slot, h, first)

    def _decode_chunk(self):
        if self._pools:
            self._pool_prewrite()
            self._flush_tables()
        dev, n = self.device, self.steps_per_sync
        t0 = self._clock()
        temps = self._temps.copy()
        gens = list(self._gens)
        toks, done, bad, live = self._decode_steps(
            n, torch.as_tensor(self._tok, device=dev),
            torch.as_tensor(self._done, device=dev),
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(self._eos, device=dev), gens, temps)
        packed = torch.cat([toks, done[:, None].long(), bad[:, None].long(),
                            live[:, None].long()], dim=1)
        self.n_decode_steps += n
        if self._host is not None:
            r, arr, ready = self._to_ring(packed)
        else:
            arr = packed.cpu().numpy()         # ONE device->host copy
        # one-shot NaN flags reset only once the chunk has run
        self._nan_inject[:] = False
        self._watchdog(self._clock() - t0)     # device work included
        self._tok = arr[:, n - 1:n].copy()
        self._done = arr[:, n].astype(bool)
        if self._host is not None:
            self._enqueue_chunk(arr, r, ready)
            return
        for i in range(self.batch_slots):
            h = self._slot_handle[i]
            if h is None:
                continue
            self._hostlen[i] += n
            if arr[i, n + 1] and not h.finished:
                # NaN quarantine (§11): drop the chunk, shed the stream
                self._counters["nan_quarantines"] += 1
                self._finish(h, FinishReason.SHED)   # retire frees the slot
                continue
            self._deliver(i, arr[i, :n].tolist())

    def _decode_steps(self, n: int, token, done, temps, eos, gens,
                      temps_host):
        """``n`` decode steps -> (tokens (B, n), done, bad, live): the eager
        :func:`multi_decode` until :meth:`warmup` has captured the step,
        then ``n`` replays of the captured :func:`decode_one` (DESIGN.md
        §10), the uniforms buffer filled from the same generators in the
        same slot order before each step, so streams stay identical.  The
        NaN guard (DESIGN.md §11) of the chunk's flagged slots is written
        into the static guard buffer before the replays and zeroed after
        them, in stream order; with no slot flagged it is not touched."""
        armed = bool(self._nan_inject.any())
        if self._unif is None:
            nan = (torch.tensor(self._nan_inject, device=self.device)
                   if armed else None)
            toks, _, self._caches, done, bad, live = multi_decode(
                self.params, self.cfg, self.schedule, n, token, self._caches,
                done, temps, eos, calib=self.calib, backend=self.backend,
                uniforms=lambda: self._uniforms(gens, temps_host),
                nan_inject=nan)
            return toks, done, bad, live
        b, dev = self.batch_slots, self.device
        bad = torch.zeros(b, dtype=torch.bool, device=dev)
        live = torch.zeros(b, dtype=torch.int32, device=dev)
        toks = torch.empty((b, n), dtype=torch.int64, device=dev)
        if armed:
            self._nan_dev.copy_(torch.as_tensor(self._nan_inject))
        for s in range(n):
            unif = self._uniforms(gens, temps_host)
            if unif is not None:
                self._unif.copy_(unif)
            # the greedy rows ignore their draws (sample_per_slot), so one
            # graph serves greedy, sampled and mixed batches alike
            nxt, done, bad, live = self._graphs.call(
                "decode_step", self._step, token, done, bad, live, temps,
                eos, self._unif, self._nan_dev)
            toks[:, s] = nxt
            token = nxt[:, None]
        if armed:
            self._nan_dev.zero_()
        return toks, done, bad, live

    def _step(self, token, done, bad, live, temps, eos, uniforms,
              nan_inject):
        """The captured step: :func:`decode_one` on the engine's caches,
        with the static NaN guard."""
        return decode_one(self.params, self.cfg, self.schedule, token,
                          self._caches, done, bad, live, temps, eos,
                          uniforms, calib=self.calib, backend=self.backend,
                          nan_inject=nan_inject)

    def _ring_slot(self, shape) -> int:
        """A free host buffer of the async delivery ring (``host_queue +
        1`` of them, pinned on CUDA): waits, as backpressure, until the
        consumer has released the buffer's previous chunk, so neither a
        later copy nor a later replay overwrites undelivered tokens."""
        if not self._ring:
            pin = self.device.type == "cuda"
            for _ in range(self._host.max_queue + 1):
                self._ring.append(torch.empty(shape, dtype=torch.int64,
                                              pin_memory=pin))
                self._ring_free.append(threading.Event())
                self._ring_free[-1].set()
        r = self._ring_next
        self._ring_next = (r + 1) % len(self._ring)
        free = self._ring_free[r]
        if not free.is_set():
            self._host.backpressure_waits += 1
            t0 = self._clock()
            free.wait()
            self._host.backpressure_s += self._clock() - t0
        free.clear()
        return r

    def _to_ring(self, packed: torch.Tensor):
        """One chunk's tokens and flags into a ring buffer: a non-blocking
        copy with a CUDA event behind it, synchronized here for the flags
        the scheduler reads.  Returns (ring index, host array, event)."""
        r = self._ring_slot(tuple(packed.shape))
        buf = self._ring[r]
        ready = None
        if self.device.type == "cuda":
            buf.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            ready.synchronize()                # the flags, for the scheduler
        else:
            buf.copy_(packed)
        return r, buf.numpy(), ready

    def _enqueue_chunk(self, arr: np.ndarray, r: int, ready):
        """Async delivery of one chunk (DESIGN.md §10): the scheduler
        decides every finish from the ``done``/``bad``/``live`` flags of
        ring buffer ``r``, and the consumer thread delivers the tokens."""
        n = self.steps_per_sync
        handles, rows, counts, reasons = [], [], [], []
        for i in range(self.batch_slots):
            h = self._slot_handle[i]
            if h is None or h._sched_fin is not None:
                continue
            self._hostlen[i] += n
            if arr[i, n + 1]:
                # NaN quarantine (§11): drop the chunk, shed the stream
                self._counters["nan_quarantines"] += 1
                consumed, reason = 0, FinishReason.SHED
            else:
                left = h.request.max_new - h._sched_consumed
                n_live = int(arr[i, n + 2])
                if arr[i, n] and n_live <= left:
                    consumed, reason = n_live, FinishReason.EOS
                elif left <= n_live:
                    consumed, reason = left, FinishReason.LENGTH
                else:
                    consumed, reason = n_live, None
            h._sched_consumed += consumed
            h._sched_fin = reason
            handles.append(h)
            rows.append(i)
            counts.append(consumed)
            reasons.append(reason)
        free = self._ring_free[r]
        if not handles:
            free.set()
            return
        self._host.put(TokenDelivery(
            handles=handles, rows=rows, counts=counts, reasons=reasons,
            tokens=arr, ready=ready, release=free.set))

    def _admit_deliver(self, slot: int, h: StreamHandle, first: int):
        """Deliver a request's first (admission-sampled) token: directly in
        the synchronous loop, through the host-loop queue in async mode —
        the transport every decode chunk takes (DESIGN.md §10)."""
        if self._host is None:
            if h.first_token_time is None:   # kept across preemptions
                h.first_token_time = self._clock()
            self._deliver(slot, [first])
            return
        req = h.request
        if req.eos_id is not None and first == req.eos_id:
            reason = FinishReason.EOS
        elif req.max_new <= 1:
            reason = FinishReason.LENGTH
        else:
            reason = None
        h._sched_consumed = 1
        h._sched_fin = reason
        self._host.put(TokenDelivery(
            handles=[h], rows=[0], counts=[1], reasons=[reason],
            tokens=np.asarray([[first]], np.int64)))

    def _deliver(self, slot: int, tokens: List[int]):
        """Append chunk tokens to a slot's handle, honoring eos/max_new.
        After a preemption the replay filter runs first (DESIGN.md §11):
        regenerated tokens already delivered are checked and dropped."""
        h = self._slot_handle[slot]
        if h.finished:
            return
        req = h.request
        taken: List[int] = []
        for t in h._absorb_replay(tokens):
            if h.finished:
                break
            h.tokens.append(t)
            taken.append(t)
            if req.eos_id is not None and t == req.eos_id:
                self._finish(h, FinishReason.EOS)
            elif len(h.tokens) >= req.max_new:
                self._finish(h, FinishReason.LENGTH)
        if self._detok is not None and taken:
            h.text += self._detok(taken)

    def _finish(self, h: StreamHandle, reason: str):
        h.finished = True
        h.finish_reason = reason
        h.finish_time = self._clock()


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    return {k: _to(v, device) for k, v in tree.items()}


def _band(caches, group: str, bkey: str):
    """The stacked caches of band ``bkey`` of a cache group (flat for one
    band, band-keyed for several; DESIGN.md §8)."""
    g = caches[group]
    return g[bkey] if T.band_keyed(g) else g


def _zero(tree) -> None:
    """In place: zero every leaf of a (band-keyed or flat) cache tree."""
    if torch.is_tensor(tree):
        tree.zero_()
        return
    for v in tree.values():
        _zero(v)


# ------------------------------------------------------- compatibility shim

class ServeSession:
    """Lock-step array API over :class:`Engine` (DESIGN.md §6
    "Compatibility"): ``generate(prompts (B, S), max_new)`` submits one
    request per slot and runs the engine to completion."""

    def __init__(self, params, cfg: ArchConfig, policy, batch_slots: int,
                 max_len: int, calib=None, temperature=0.0, seed: int = 0,
                 backend=None, steps_per_sync: int = 8,
                 eos_id: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 pool_block_tokens: int = 16, device=None):
        self.engine = Engine(params, cfg, policy, batch_slots=batch_slots,
                             max_len=max_len, calib=calib, seed=seed,
                             backend=backend, steps_per_sync=steps_per_sync,
                             pool_blocks=pool_blocks,
                             pool_block_tokens=pool_block_tokens,
                             device=device)
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.seed = seed

    def generate(self, prompts: np.ndarray, max_new: int = 16) -> np.ndarray:
        """prompts (B, S), B == batch_slots -> (B, max_new) int32; post-EOS
        positions are padded with ``eos_id`` (DESIGN.md §6)."""
        prompts = np.asarray(prompts)
        if prompts.ndim != 2 or prompts.shape[0] != self.batch_slots:
            raise ValueError(f"prompts must be ({self.batch_slots}, S), got "
                             f"{prompts.shape}")
        if prompts.shape[1] + max_new > self.max_len:
            raise ValueError(f"prompt_len ({prompts.shape[1]}) + max_new "
                             f"({max_new}) exceeds max_len ({self.max_len})")
        handles = [self.engine.submit(Request(
            prompt=prompts[i], max_new=max_new, temperature=self.temperature,
            eos_id=self.eos_id, seed=self.seed + i))
            for i in range(self.batch_slots)]
        self.engine.run(handles)
        out = np.full((self.batch_slots, max_new),
                      self.eos_id if self.eos_id is not None else 0, np.int32)
        for i, h in enumerate(handles):
            toks = h.result()
            out[i, :len(toks)] = toks
        return out
