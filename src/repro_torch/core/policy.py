"""Quantization policy (port of ``repro.core.policy``; DESIGN.md §8).

Two levels, as in the reference:

* :class:`QuantPolicy` says how ONE layer's KV cache is quantized; it is
  frozen and hashable.
* :class:`PolicySchedule` is the layer-indexed container (``schedule[i] ->
  QuantPolicy``) the stack runs on: fp16 guard layers and bits ladders are
  schedules.  Consumers split it into contiguous equal-policy bands
  (:meth:`PolicySchedule.bands`), each with its own cache layout.  A bare
  :class:`QuantPolicy` coerces to a uniform schedule (:func:`as_schedule`),
  which runs exactly the single-policy program.

The baseline switches of the reference (``smooth``, ``per_channel_key``)
select the fake-quant baselines of :mod:`repro_torch.core.baselines`; each
excludes ``reorder``, and an fp16 guard layer clears both.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

_ALLOWED_BITS = (1.0, 1.5, 2.0, 3.0, 4.0, 8.0, 16.0)


def bit_planes(bits: float) -> Tuple[Tuple[int, float], ...]:
    """Decompose a (possibly fractional) bit width into integer planes.

    Returns ((bits, fraction_of_groups), ...).  1.5 -> ((2, .5), (1, .5));
    3.0 -> ((4, .5), (2, .5)) (byte-aligned packing only supports 1/2/4/8).
    """
    if bits == 1.5:
        return ((2, 0.5), (1, 0.5))
    if bits == 3.0:
        return ((4, 0.5), (2, 0.5))
    b = int(bits)
    if b != bits or b not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported bits {bits}")
    return ((b, 1.0),)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """How to quantize ONE layer's KV cache (DESIGN.md §1–§3)."""

    bits_k: float = 2.0
    bits_v: float = 2.0
    group_size: int = 128          # channels per quant group (within head_dim)
    window: int = 128              # fp sliding-window length (0 = no window)
    n_sink: int = 5                # attention-sink tokens kept fp forever
    fp8_meta: bool = True          # store scale/zero in FP8-E4M3 (else fp16)
    clip: bool = True              # use calibrated per-group clip alpha
    reorder: bool = True           # use calibrated per-head channel permutation
    # --- baseline switches (mutually exclusive with reorder) ---
    smooth: bool = False           # SmoothQuant-style per-channel equalization
    per_channel_key: bool = False  # KIVI-style: K quantized along the token axis
    # ---
    meta_dtype_bits: int = dataclasses.field(init=False, default=8)

    def __post_init__(self):
        if self.bits_k not in _ALLOWED_BITS or self.bits_v not in _ALLOWED_BITS:
            raise ValueError(f"bits must be in {_ALLOWED_BITS}")
        if self.group_size <= 0:
            raise ValueError("group_size must be positive")
        if self.reorder and (self.smooth or self.per_channel_key):
            bad = "smooth" if self.smooth else "per_channel_key"
            raise ValueError(
                f"reorder=True is mutually exclusive with the baseline "
                f"switch {bad}=True: the calibrated channel permutation and "
                f"the {bad} baseline transform the same channel axis; pick "
                f"one (baselines set reorder=False)")
        if self.bits_k >= 16 and self.bits_v >= 16 and \
                (self.window > 0 or self.n_sink > 0):
            raise ValueError(
                f"window ({self.window}) / n_sink ({self.n_sink}) are "
                f"meaningless on an fp16 policy; use window=0, n_sink=0")
        object.__setattr__(self, "meta_dtype_bits", 8 if self.fp8_meta else 16)

    @property
    def is_fp16(self) -> bool:
        return self.bits_k >= 16 and self.bits_v >= 16

    def avg_bits(self, head_dim: int) -> float:
        """Average bits per element with metadata (the paper's avg-bits);
        an fp16 policy stores no scale/zero and counts exactly 16."""
        if self.is_fp16:
            return 16.0
        g = min(self.group_size, head_dim)
        return (self.bits_k + self.bits_v) / 2 + 2 * self.meta_dtype_bits / g

    def without_window(self) -> "QuantPolicy":
        """This policy with the fp window and the sinks removed: the policy
        of a cross-attention cache, which prefill quantizes whole and
        decode never appends to (DESIGN.md §8)."""
        if self.window == 0 and self.n_sink == 0:
            return self
        return dataclasses.replace(self, window=0, n_sink=0)  # reprolint: disable=RL003 -- the named constructor RL003 points callers at (DESIGN.md §8)


FP16_POLICY = QuantPolicy(bits_k=16.0, bits_v=16.0, clip=False, reorder=False,
                          window=0, n_sink=0)
# The paper's headline configuration (Sec. 4.2, Fig. 4): K2 V1.5, g128, w128.
PAPER_POLICY = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=128,
                           n_sink=5, fp8_meta=True)


def fp16_guard(policy: QuantPolicy) -> QuantPolicy:
    """The fp16 policy of a guard layer: the base policy's metadata knobs,
    nothing quantized and no window (DESIGN.md §8)."""
    return dataclasses.replace(policy, bits_k=16.0, bits_v=16.0, window=0,  # reprolint: disable=RL003 -- fp16_guard is itself a named derivation site (DESIGN.md §8)
                               n_sink=0, clip=False, reorder=False,
                               smooth=False, per_channel_key=False)


# ============================================================ PolicySchedule

@dataclasses.dataclass(frozen=True)
class PolicySchedule:
    """Layer-indexed policy container (DESIGN.md §8): ``schedule[i]`` is
    layer ``i``'s :class:`QuantPolicy`.  Frozen over a tuple, so it is
    hashable and can key the Engine's and the graph cache's state like a
    bare policy.  Build one from the presets (:meth:`uniform`,
    :meth:`first_last_fp16`, :meth:`bits_ladder`, :meth:`for_arch`) or from
    an explicit per-layer tuple."""

    layers: Tuple[QuantPolicy, ...]

    def __post_init__(self):
        layers = tuple(self.layers)
        if not layers:
            raise ValueError("PolicySchedule needs at least one layer")
        for p in layers:
            if not isinstance(p, QuantPolicy):
                raise TypeError(f"PolicySchedule entries must be QuantPolicy, "
                                f"got {type(p).__name__}")
        object.__setattr__(self, "layers", layers)

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i: int) -> QuantPolicy:
        return self.layers[i]

    def __iter__(self) -> Iterator[QuantPolicy]:
        return iter(self.layers)

    @property
    def is_uniform(self) -> bool:
        return all(p == self.layers[0] for p in self.layers)

    def distinct(self) -> Tuple[QuantPolicy, ...]:
        """Distinct policies in first-appearance order."""
        out = []
        for p in self.layers:
            if p not in out:
                out.append(p)
        return tuple(out)

    def bands(self, start: int = 0, stop: Optional[int] = None
              ) -> Tuple[Tuple[int, int, QuantPolicy], ...]:
        """Contiguous equal-policy runs ``((band_start, band_stop, policy),
        ...)`` over ``[start, stop)``: one cache layout per band; a uniform
        schedule yields exactly one band."""
        stop = len(self.layers) if stop is None else stop
        if not (0 <= start < stop <= len(self.layers)):
            raise ValueError(f"band range [{start}, {stop}) out of bounds "
                             f"for {len(self.layers)} layers")
        out = []
        b0 = start
        for i in range(start + 1, stop + 1):
            if i == stop or self.layers[i] != self.layers[b0]:
                out.append((b0, i, self.layers[b0]))
                b0 = i
        return tuple(out)

    # ----------------------------------------------------------- accounting
    def avg_bits(self, head_dim: int) -> float:
        """Layer-weighted average bits per element (fp16 layers count 16)."""
        return sum(p.avg_bits(head_dim) for p in self.layers) / len(self.layers)

    def layer_avg_bits(self, head_dim: int) -> Tuple[float, ...]:
        """Per-layer avg-bits breakdown."""
        return tuple(p.avg_bits(head_dim) for p in self.layers)

    def layer_kv_bytes(self, head_dim: int, n_kv: int = 1) -> Tuple[int, ...]:
        """Per-layer packed KV bytes per token (K and V, all heads) in the
        quantized steady state; fp16 layers store raw 2-byte K/V."""
        from .quant import packed_nbytes  # local: quant imports policy
        out = []
        for p in self.layers:
            if p.is_fp16:
                out.append(2 * 2 * head_dim * n_kv)
                continue
            g = min(p.group_size, head_dim)
            out.append(n_kv * (packed_nbytes(head_dim, p.bits_k, g,
                                             p.meta_dtype_bits)
                               + packed_nbytes(head_dim, p.bits_v, g,
                                               p.meta_dtype_bits)))
        return tuple(out)

    def kv_bytes_per_token(self, head_dim: int, n_kv: int = 1) -> int:
        """Packed KV bytes per token summed over all layers."""
        return sum(self.layer_kv_bytes(head_dim, n_kv))

    def layer_table(self, head_dim: int, n_kv: int = 1) -> Tuple[dict, ...]:
        """Per-layer rows (bits, group, window, sinks, avg-bits, packed bytes
        per token); the CLI prints the allocation view instead
        (``kv_cache.schedule_cache_nbytes``, which counts the fp buffers)."""
        nbytes = self.layer_kv_bytes(head_dim, n_kv)
        return tuple(
            {"layer": i, "bits_k": p.bits_k, "bits_v": p.bits_v,
             "group": min(p.group_size, head_dim), "window": p.window,
             "n_sink": p.n_sink, "avg_bits": p.avg_bits(head_dim),
             "kv_bytes_per_token": nbytes[i]}
            for i, p in enumerate(self.layers))

    # -------------------------------------------------------------- presets
    @classmethod
    def uniform(cls, policy: QuantPolicy, n_layers: Optional[int] = None):
        """Every layer runs ``policy``: what a bare policy coerces to.  With
        ``n_layers`` omitted, a :class:`SchedulePreset`."""
        if n_layers is None:
            return SchedulePreset("uniform", policy)
        return cls((policy,) * n_layers)

    @classmethod
    def first_last_fp16(cls, policy: QuantPolicy, n_guard: int = 1,
                        n_layers: Optional[int] = None):
        """fp16 guard layers: the first and last ``n_guard`` layers stay
        uncompressed (:func:`fp16_guard`), the rest run ``policy``.  With
        ``n_layers`` omitted, a :class:`SchedulePreset` that the consumer
        materializes against its own depth."""
        if n_guard < 0:
            raise ValueError(f"n_guard must be >= 0, got {n_guard}")
        if n_layers is None:
            return SchedulePreset("first_last_fp16", policy, (n_guard,))
        if n_guard > 0 and 2 * n_guard >= n_layers:
            raise ValueError(
                f"first_last_fp16 with n_guard={n_guard} on {n_layers} "
                f"layers leaves NO quantized layers — the schedule would "
                f"silently serve the fp16 baseline; lower n_guard (need "
                f"2 * n_guard < n_layers)")
        guard = fp16_guard(policy)
        return cls(tuple(
            guard if (i < n_guard or i >= n_layers - n_guard) else policy
            for i in range(n_layers)))

    @classmethod
    def bits_ladder(cls, policy: QuantPolicy,
                    ladder: Sequence[Tuple[float, float]] = ((4.0, 4.0),
                                                            (2.0, 2.0),
                                                            (2.0, 1.5)),
                    n_layers: Optional[int] = None):
        """Mixed-precision ladder: the layers split into ``len(ladder)``
        even contiguous groups, group ``j`` running ``policy`` at
        ``(bits_k, bits_v) = ladder[j]`` (a 16/16 rung is an fp16 guard)."""
        ladder = tuple((float(bk_), float(bv)) for bk_, bv in ladder)
        if not ladder:
            raise ValueError("bits_ladder needs at least one (bits_k, bits_v)")
        if n_layers is None:
            return SchedulePreset("bits_ladder", policy, (ladder,))
        m = len(ladder)
        out = []
        for i in range(n_layers):
            bk_, bv = ladder[min(i * m // n_layers, m - 1)]
            if bk_ >= 16 and bv >= 16:
                out.append(fp16_guard(policy))
            else:
                out.append(dataclasses.replace(policy, bits_k=bk_, bits_v=bv))  # reprolint: disable=RL003 -- schedule preset: one of the named derivation sites of DESIGN.md §8
        return cls(tuple(out))

    @classmethod
    def for_arch(cls, policy: QuantPolicy, cfg) -> "PolicySchedule":
        """Layers the config marks local cap their fp window at the
        attention window ``cfg.local_window``."""
        out = []
        for i in range(cfg.n_layers):
            p = policy
            if (not policy.is_fp16 and cfg.local_window > 0
                    and cfg.layer_is_local(i)
                    and policy.window > cfg.local_window):
                p = dataclasses.replace(policy, window=cfg.local_window)  # reprolint: disable=RL003 -- schedule preset: one of the named derivation sites of DESIGN.md §8
            out.append(p)
        return cls(tuple(out))


@dataclasses.dataclass(frozen=True)
class SchedulePreset:
    """A named schedule awaiting its layer count (DESIGN.md §8);
    :func:`as_schedule` materializes it against the consumer's depth."""

    kind: str
    policy: QuantPolicy
    args: Tuple = ()

    def materialize(self, n_layers: int) -> PolicySchedule:
        if self.kind == "uniform":
            return PolicySchedule.uniform(self.policy, n_layers)
        if self.kind == "first_last_fp16":
            return PolicySchedule.first_last_fp16(self.policy, self.args[0],
                                                  n_layers)
        if self.kind == "bits_ladder":
            return PolicySchedule.bits_ladder(self.policy, self.args[0],
                                              n_layers)
        raise ValueError(f"unknown schedule preset {self.kind!r}")


def as_schedule(policy, n_layers: int) -> PolicySchedule:
    """Coerce policy | schedule | preset | per-layer sequence to a
    :class:`PolicySchedule` of exactly ``n_layers`` (DESIGN.md §8): a bare
    policy means ``PolicySchedule.uniform(policy, n_layers)``, a preset
    materializes, a schedule must already cover ``n_layers``."""
    if isinstance(policy, PolicySchedule):
        if len(policy) != n_layers:
            raise ValueError(f"PolicySchedule covers {len(policy)} layers "
                             f"but the model has {n_layers}")
        return policy
    if isinstance(policy, SchedulePreset):
        return policy.materialize(n_layers)
    if isinstance(policy, QuantPolicy):
        return PolicySchedule.uniform(policy, n_layers)
    if isinstance(policy, (tuple, list)):
        return as_schedule(PolicySchedule(tuple(policy)), n_layers)
    raise TypeError(f"expected QuantPolicy | PolicySchedule | SchedulePreset, "
                    f"got {type(policy).__name__}")


def as_layer_policy(policy) -> QuantPolicy:
    """Coerce to a single-layer :class:`QuantPolicy` (DESIGN.md §8).

    Per-layer consumers (cache container, kernels, backends) take exactly
    one policy: a uniform schedule collapses to its policy, a non-uniform
    one must be indexed (``schedule[i]``) by the caller first."""
    if isinstance(policy, QuantPolicy):
        return policy
    if isinstance(policy, PolicySchedule):
        if policy.is_uniform:
            return policy.layers[0]
        raise TypeError(
            "this consumer is per-layer: index the non-uniform schedule "
            "(schedule[i]) or pass one QuantPolicy; got a schedule with "
            f"{len(policy.distinct())} distinct policies")
    raise TypeError(f"expected QuantPolicy | uniform PolicySchedule, "
                    f"got {type(policy).__name__}")
