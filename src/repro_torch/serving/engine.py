"""Request-level serving engine, main path (port of
``repro.serving.engine``; DESIGN.md §6).

* :class:`Request` — prompt, max_new, temperature, eos_id, seed.
* :class:`Engine` — ``submit() -> StreamHandle``, ``step()``, ``run()``
  over ``batch_slots`` decode lanes.  Admission prefills queued requests
  whole-prompt (equal prompt lengths batch together) into free slots only;
  retirement zeroes the slot.  Decode runs ``steps_per_sync`` tokens per
  host sync (:func:`multi_decode`): tokens, EOS pinning and the per-slot
  ``live``/``done``/``bad`` flags stay on the device, and one copy per
  chunk brings them to the host.
* :class:`ServeSession` — the lock-step array shim over :class:`Engine`.

The per-slot cache length (``cache["length"]`` is ``(B,)``) is what lets
slots at different positions decode in one batched step.  All engine time
flows through the injectable ``clock=`` (DESIGN.md §11).

Greedy streams match the reference engine token for token.  Sampling
(temperature > 0) uses a per-slot ``torch.Generator`` seeded from the
engine and request seeds, so a stream is reproducible per seed but is not
``jax.random``'s.  Chunked prefill, the block pool, the async host loop,
warmup and the degradation ladder of the reference are not ported yet;
the Engine does not accept their arguments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import kv_cache as kvc
from ..core.policy import as_layer_policy
from ..device import resolve_device
from ..models.config import ArchConfig
from ..models import backends as bk
from ..models import transformer as T


# ------------------------------------------------------------------ sampling

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


def multi_decode(params, cfg: ArchConfig, policy, n_tokens: int, token,
                 caches, done, temps, eos, calib=None, backend=None,
                 uniforms: Optional[Callable] = None):
    """``n_tokens`` decode steps with per-slot sampling and EOS pinning, all
    on the device (DESIGN.md §6; the reference's scanned multi-decode).

    token (B, 1), done (B,) bool, temps (B,) f32, eos (B,) (< 0 disables
    EOS for that slot).  ``uniforms()`` returns (B, V) draws or None.
    Returns (tokens (B, n), token, caches, done, bad, live): ``live`` counts
    tokens emitted before pinning (the EOS token included); a slot whose
    logits go non-finite raises ``bad``, samples from zeroed logits and
    pins ``done``.  ``caches`` are updated in place."""
    b = token.shape[0]
    bad = torch.zeros(b, dtype=torch.bool, device=token.device)
    live = torch.zeros(b, dtype=torch.int32, device=token.device)
    has = eos >= 0
    out = []
    for _ in range(n_tokens):
        logits, caches = T.decode_step(params, cfg, token, caches, policy,
                                       calib=calib, backend=backend)
        row = logits[:, -1].to(torch.float32)
        bad = bad | ~torch.isfinite(row).all(dim=-1)
        safe = torch.where(bad[:, None], torch.zeros_like(row), row)
        nxt = sample_per_slot(safe, temps, None if uniforms is None
                              else uniforms())
        nxt = torch.where(done & has, eos.to(nxt.dtype), nxt)
        live = live + torch.where(done | bad, 0, 1).to(torch.int32)
        done = done | (has & (nxt == eos)) | bad
        token = nxt[:, None]
        out.append(nxt)
    return torch.stack(out, dim=1), token, caches, done, bad, live


# ------------------------------------------------------------------ requests

class FinishReason:
    """Stream-termination reasons (DESIGN.md §11); the port's main path
    ends streams with ``eos``, ``length`` or ``shed`` (non-finite logits)."""
    EOS = "eos"
    LENGTH = "length"
    SHED = "shed"


@dataclasses.dataclass
class Request:
    """One generation job (DESIGN.md §6): prompt (1-D token ids), max_new
    budget, temperature (<= 0 greedy), optional eos_id, and a seed for the
    request's own sampling stream."""
    prompt: Sequence[int]
    max_new: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0


class StreamHandle:
    """Live view of one submitted request (DESIGN.md §6): ``tokens`` grows
    after every sync; ``finished``/``finish_reason`` flip at EOS or the
    max_new budget; submit/admit/first-token/finish marks come from the
    engine clock."""

    def __init__(self, request: Request, rid: int,
                 now: Optional[float] = None):
        self.request = request
        self.rid = rid
        self.tokens: List[int] = []
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.submit_time = now
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None

    def result(self) -> np.ndarray:
        """The generated tokens so far as a 1-D int32 array."""
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        state = self.finish_reason if self.finished else "running"
        return f"StreamHandle(rid={self.rid}, tokens={len(self.tokens)}, {state})"


# -------------------------------------------------------------------- engine

class Engine:
    """Continuous-batching engine over ``batch_slots`` decode lanes
    (DESIGN.md §6).

    ``policy`` is one :class:`~repro_torch.core.policy.QuantPolicy` for
    every layer.  ``backend`` is ``"cuda"``, ``"reference"``, an instance,
    or None for the device's default (``"cuda"`` on a card).  ``max_len``
    is the per-slot cache capacity: ``len(prompt) + max_new <= max_len``
    is checked at submit.  ``dtype`` casts the params once, here.
    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"``; params and calib move to it.  ``clock`` (default
    ``time.monotonic``) stamps every latency mark (DESIGN.md §11).
    """

    def __init__(self, params, cfg: ArchConfig, policy, batch_slots: int,
                 max_len: int, calib=None, seed: int = 0, backend=None,
                 steps_per_sync: int = 8, dtype=None,
                 clock: Optional[Callable[[], float]] = None, device=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = as_layer_policy(policy)
        self.params = _to(T._cast_params(params, dtype), self.device)
        self.calib = T._calib(None if calib is None else
                              _to(calib, self.device), cfg, self.policy,
                              self.device)
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

    # ------------------------------------------------------------ public API

    @property
    def backend_info(self) -> dict:
        """Backend, policy and device facts (DESIGN.md §4)."""
        out = dict(self.backend.info())
        out.update({"device": str(self.device), "policy": self.policy,
                    "batch_slots": self.batch_slots, "max_len": self.max_len,
                    "steps_per_sync": self.steps_per_sync})
        return out

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (DESIGN.md §6)."""
        return len(self._queue)

    @property
    def active_slots(self) -> int:
        """Slots holding a request (DESIGN.md §6)."""
        return sum(h is not None for h in self._slot_handle)

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
        if prompt.size + request.max_new > self.max_len:
            raise ValueError(
                f"Request.prompt length ({prompt.size}) + Request.max_new "
                f"({request.max_new}) exceeds the engine's per-slot cache "
                f"capacity max_len={self.max_len}")
        request = dataclasses.replace(request, prompt=prompt)
        handle = StreamHandle(request, self._next_rid, now=self._clock())
        self._next_rid += 1
        self._queue.append(handle)
        return handle

    def step(self) -> bool:
        """One scheduler tick: retire -> admit -> one decode chunk
        (DESIGN.md §6).  False when there is nothing left to do."""
        self._retire()
        self._admit()
        active = [i for i in range(self.batch_slots)
                  if self._slot_handle[i] is not None]
        if not active:
            return bool(self._queue)
        if any(not self._slot_handle[i].finished for i in active):
            self._decode_chunk()
        self._retire()
        return True

    def run(self, handles: Optional[List[StreamHandle]] = None) -> None:
        """Step until the given handles (default: everything) finish."""
        def pending():
            if handles is not None:
                return any(not h.finished for h in handles)
            return bool(self._queue) or any(
                h is not None for h in self._slot_handle)

        while pending():
            if not self.step():
                break

    # --------------------------------------------------------------- details

    def _retire(self):
        for i, h in enumerate(self._slot_handle):
            if h is not None and h.finished:
                self._release_slot(i)

    def _release_slot(self, i: int):
        """Free lane ``i``: host mirrors clear and the device row zeroes."""
        self._slot_handle[i] = None
        self._done[i] = True
        self._eos[i] = -1
        self._temps[i] = 0.0
        self._gens[i] = None
        if self._caches is not None:
            kvc.reset_slot(self._caches, i, batch_axis=1)

    def _admit(self):
        """Whole-prompt admission into free slots (DESIGN.md §6): equal
        prompt lengths prefill as one batch, distinct lengths batch-of-1 —
        no cross-slot padding ever enters the model."""
        free = [i for i in range(self.batch_slots)
                if self._slot_handle[i] is None]
        if not free or not self._queue:
            return
        take, self._queue = (self._queue[:len(free)],
                             self._queue[len(free):])
        groups: Dict[int, List[StreamHandle]] = {}
        for h in take:
            groups.setdefault(len(h.request.prompt), []).append(h)
        it = iter(free)
        for hs in groups.values():
            self._admit_group(hs, [next(it) for _ in hs])

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
            self.policy, calib=self.calib, max_len=self.max_len,
            backend=self.backend)
        temps = [max(float(h.request.temperature), 0.0) for h in handles]
        gens = [self._generator(h.request.seed) for h in handles]
        first = sample_per_slot(
            logits[:, -1].to(torch.float32),
            torch.tensor(temps, dtype=torch.float32, device=self.device),
            self._uniforms(gens, temps)).cpu().numpy()
        if self._caches is None:
            self._caches = _alloc_like(caches, self.batch_slots)
        now = self._clock()
        for row, (h, slot) in enumerate(zip(handles, slots)):
            kvc.insert_slot(self._caches, slot, caches, src_slot=row,
                            batch_axis=1)
            req = h.request
            self._slot_handle[slot] = h
            self._tok[slot, 0] = first[row]
            self._temps[slot] = temps[row]
            self._gens[slot] = gens[row]
            self._eos[slot] = -1 if req.eos_id is None else req.eos_id
            self._done[slot] = (req.eos_id is not None
                                and int(first[row]) == req.eos_id)
            h.admit_time = now
            h.first_token_time = self._clock()
            self._deliver(slot, [int(first[row])])

    def _decode_chunk(self):
        dev, n = self.device, self.steps_per_sync
        temps = self._temps.copy()
        gens = list(self._gens)
        toks, _, self._caches, done, bad, live = multi_decode(
            self.params, self.cfg, self.policy, n,
            torch.as_tensor(self._tok, device=dev), self._caches,
            torch.as_tensor(self._done, device=dev),
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(self._eos, device=dev), calib=self.calib,
            backend=self.backend,
            uniforms=lambda: self._uniforms(gens, temps))
        # ONE device->host copy per chunk
        host = torch.cat([toks, done[:, None].long(), bad[:, None].long(),
                          live[:, None].long()], dim=1).cpu().numpy()
        self.n_decode_steps += n
        self._tok = host[:, n - 1:n].copy()
        self._done = host[:, n].astype(bool)
        for i in range(self.batch_slots):
            h = self._slot_handle[i]
            if h is None:
                continue
            if host[i, n + 1] and not h.finished:
                self._finish(h, FinishReason.SHED)   # retire frees the slot
                continue
            self._deliver(i, host[i, :n].tolist())

    def _deliver(self, slot: int, tokens: List[int]):
        """Append chunk tokens to a slot's handle, honoring eos/max_new."""
        h = self._slot_handle[slot]
        req = h.request
        for t in tokens:
            if h.finished:
                break
            h.tokens.append(int(t))
            if req.eos_id is not None and t == req.eos_id:
                self._finish(h, FinishReason.EOS)
            elif len(h.tokens) >= req.max_new:
                self._finish(h, FinishReason.LENGTH)

    def _finish(self, h: StreamHandle, reason: str):
        h.finished = True
        h.finish_reason = reason
        h.finish_time = self._clock()


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    return {k: _to(v, device) for k, v in tree.items()}


def _alloc_like(caches, batch_slots: int):
    """Zeroed engine caches: the prefilled groups' structure with the batch
    axis (axis 1 of every layer-stacked leaf) widened to batch_slots."""
    if torch.is_tensor(caches):
        shape = (caches.shape[0], batch_slots) + tuple(caches.shape[2:])
        return torch.zeros(shape, dtype=caches.dtype, device=caches.device)
    return {k: _alloc_like(v, batch_slots) for k, v in caches.items()}


# ------------------------------------------------------- compatibility shim

class ServeSession:
    """Lock-step array API over :class:`Engine` (DESIGN.md §6
    "Compatibility"): ``generate(prompts (B, S), max_new)`` submits one
    request per slot and runs the engine to completion."""

    def __init__(self, params, cfg: ArchConfig, policy, batch_slots: int,
                 max_len: int, calib=None, temperature=0.0, seed: int = 0,
                 backend=None, steps_per_sync: int = 8,
                 eos_id: Optional[int] = None, device=None):
        self.engine = Engine(params, cfg, policy, batch_slots=batch_slots,
                             max_len=max_len, calib=calib, seed=seed,
                             backend=backend, steps_per_sync=steps_per_sync,
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
