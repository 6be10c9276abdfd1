"""Paper Table 6 / Appendix 9 on the H100 (counterpart of
``benchmarks/memory_latency.py``): memory and decode latency of llama2-7b
against context, analytic and measured.

The analytic rows are the reference's, under the same names and fields,
from its roofline formulas (decode step time = max(flops / peak, bytes /
bw)) with its ``n_params = 6.74e9`` and its 2e9 bytes of slack, on the
H100's constants (``launch/roofline.py``) in place of the TPU v5e's; the
max-context rows test an 80 GB device, the H100's and the paper's.

The measured rows are each analytic row that one card holds, run on it:
llama2-7b at full width and depth (random bf16 weights from a seed),
batch 1, its caches filled to the context by :func:`fill_caches` (a
prefill of that length does not fit), then decode steps through
``transformer.decode_step``: eager, and replayed as one CUDA graph (as
the Engine's warmed step is), each with its spread; the peak device
memory; and the step's share of its bound (``launch.op_cost`` counted
over one eager step, on ``launch.roofline``'s constants).  Policies:
``PAPER_POLICY`` (the reference's kv2), KV4 and fp16.  An fp16 cache runs
two ways: the port's own fp16 route (a dense f32 partial over the whole
``max_len``, ``kernels/ops.py``), and :class:`SdpaBackend`, one
``scaled_dot_product_attention`` launch a layer over the bf16 tokens, the
library yardstick.  A row that does not fit prints ``fits=false`` with
the bytes it needed; none is dropped.  The headline row is 1,048,576
tokens at ``PAPER_POLICY``: the paper's 1M-token claim.

On the CPU the measured rows run at the smoke config and a few hundred
tokens (the plain versions, host times): a rehearsal of the path.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable, Optional, Sequence

import torch

from .. import configs
from ..core.kv_cache import slot_lengths
from ..core.policy import FP16_POLICY, PAPER_POLICY, QuantPolicy
from ..core.quant import packed_nbytes
from ..device import resolve_device
from ..launch.roofline import HBM_BW, PEAK_FLOPS
from ..models import transformer as T
from ..models.backends import CudaBackend
from ..tree import leaves
from . import common as C

PEAK = PEAK_FLOPS        # H100 SXM, bf16 dense (the reference: v5e's 197e12)
BW = HBM_BW              # H100 SXM HBM3 (the reference: v5e's 819e9)
DEVICE_MEM = 80e9        # one 80 GB card: the H100's, the paper's A100-80G's
N_PARAMS = 6.74e9        # the reference's llama2-7b parameter count
SLACK = 2e9              # the reference's activations slack
T_SYNC = 0.5e-3          # host round-trip per decode sync (dispatch + D2H)
KV4 = QuantPolicy(bits_k=4.0, bits_v=4.0, group_size=128, fp8_meta=True)

ARCH = "llama2_7b"
CONTEXTS = (32768, 131072, 200000)     # the analytic batch-1 rows
HEADLINE = 1_048_576                   # the paper's 1M-token context
SMOKE_CONTEXTS = (96, 320)             # the CPU rehearsal, smoke config
FILL_CHUNK = 65536       # tokens a layer is filled by at a time
# an fp16 cache is written as drawn, with no quantizer launch to amortize:
# small chunks keep the draws' memory beside a near-full card
FP16_FILL_CHUNK = 4096
HEADROOM = 64            # cache slots past the context for the steps run
EAGER_STEPS, REPLAYS, REPEATS = 3, 5, 3


def _kv_bytes_per_token(cfg, policy):
    """Cache bytes of one token of one layer: packed K and V a kv head,
    or bf16 K and V for ``policy`` None (fp16)."""
    if policy is None:  # fp16
        return 2 * cfg.n_kv_heads * cfg.head_dim * 2
    per_head = (packed_nbytes(cfg.head_dim, policy.bits_k, policy.group_size,
                              policy.meta_dtype_bits) +
                packed_nbytes(cfg.head_dim, policy.bits_v, policy.group_size,
                              policy.meta_dtype_bits))
    return cfg.n_kv_heads * per_head


def decode_step_time(cfg, batch, seq, policy, n_params):
    """Roofline decode-step time (s) + memory (bytes) for one device."""
    pbytes = n_params * 2                    # bf16 weights
    kv = _kv_bytes_per_token(cfg, policy) * seq * batch * cfg.n_layers
    flops = 2 * n_params * batch + 4 * cfg.n_layers * batch * seq * \
        cfg.n_heads * cfg.head_dim
    t = max(flops / PEAK, (pbytes + kv) / BW)
    return t, pbytes + kv


def analytic_rows(emit):
    """The reference's rows (``memory_latency.py:48-111``), on this
    module's constants; returns ``{(batch, seq): (t_fp16, t_kv4, t_kv2)}``."""
    cfg = configs.get(ARCH)
    n_params = N_PARAMS
    kv2 = PAPER_POLICY                       # K2V1.5 g128 fp8
    kv4 = KV4
    rows = {}
    for batch, seq in ((1, 32768), (1, 131072), (1, 200000),
                       (64, 32768), (64, 131072), (64, 200000),
                       (128, 32768), (128, 131072), (128, 200000)):
        t16, m16 = decode_step_time(cfg, batch, seq, None, n_params)
        t4, m4 = decode_step_time(cfg, batch, seq, kv4, n_params)
        t2, m2 = decode_step_time(cfg, batch, seq, kv2, n_params)
        rows[(batch, seq)] = (t16, t4, t2)
        emit(C.csv_row(
            f"table6_b{batch}_s{seq}", t16 * 1e6,
            f"fp16_ms={t16*1e3:.1f},kv4_ms={t4*1e3:.1f},kv2_ms={t2*1e3:.1f},"
            f"speedup_kv2={t16/t2:.2f}x,"
            f"mem_fp16={m16/2**30:.0f}GiB,mem_kv2={m2/2**30:.0f}GiB"))
    sp = rows[(128, 200000)][0] / rows[(128, 200000)][2]
    emit(C.csv_row("table6_paper_7x_claim", 0.0,
                   f"b128_s200k_speedup={sp:.2f}x (paper: ~7x)"))

    # the Engine syncs with the host once per N decode steps; syncing per
    # token adds a host round-trip to every step
    for batch, seq in ((1, 32768), (64, 131072)):
        t2 = rows[(batch, seq)][2]
        per_tok = {n: t2 + T_SYNC / n for n in (1, 8, 32)}
        emit(C.csv_row(
            f"scan_sync_amortization_b{batch}_s{seq}", per_tok[1] * 1e6,
            f"tok_ms_N1={per_tok[1]*1e3:.2f},tok_ms_N8={per_tok[8]*1e3:.2f},"
            f"tok_ms_N32={per_tok[32]*1e3:.2f},"
            f"speedup_N32={per_tok[1]/per_tok[32]:.2f}x"))

    # ragged occupancy (DESIGN.md §4 block pruning): unpruned, a step
    # streams the capacity's packed planes; pruned, the live tokens (and a
    # local layer's window reach)
    cap = 131072
    local_w = 4096          # gemma-style local layer reach (window cap)
    kv_tok = _kv_bytes_per_token(cfg, kv2) * cfg.n_layers
    for occ in (0.01, 0.25, 1.0):
        live = int(cap * occ)
        dead = kv_tok * cap
        glob = kv_tok * live
        loc = kv_tok * min(live, local_w)
        t_dead = max(2 * n_params / PEAK, (n_params * 2 + dead) / BW)
        t_glob = max(2 * n_params / PEAK, (n_params * 2 + glob) / BW)
        emit(C.csv_row(
            f"table6_ragged_occ{int(occ * 100)}pct", t_glob * 1e6,
            f"occupancy={occ:.2f},cap={cap},live={live},"
            f"kv_bytes_unpruned={dead},kv_bytes_pruned_global={glob},"
            f"kv_bytes_pruned_local={loc},"
            f"step_speedup_vs_unpruned={t_dead / t_glob:.2f}x"))

    # max context at batch 1 on one 80 GB device (the paper's 1M claim)
    for name, pol in (("fp16", None), ("kv4", kv4), ("kv2", kv2)):
        per_tok = _kv_bytes_per_token(cfg, pol) * cfg.n_layers
        budget = DEVICE_MEM - n_params * 2 - SLACK
        max_ctx = int(budget / per_tok)
        emit(C.csv_row(f"table6_max_context_{name}", 0.0,
                       f"max_tokens={max_ctx/1e6:.2f}M"))
    return rows


# ------------------------------------------------------------ the filler

def seeded_kv(cfg, seed: int = 0, device=None) -> Callable:
    """A K/V source for :func:`fill_caches`: ``fn(layer, t0, n)`` gives the
    tokens ``[t0, t0 + n)`` of a layer as bf16 (k, v) (1, n, Hkv, D),
    normal draws from a ``torch.Generator`` seeded by (seed, layer, t0),
    made on ``device``."""
    dev = resolve_device(device)
    shape = (cfg.n_kv_heads, cfg.head_dim)

    def source(layer: int, t0: int, n: int):
        g = torch.Generator(device=dev).manual_seed(
            (seed << 40) + (layer << 24) + t0)
        return tuple(torch.randn((1, n) + shape, generator=g, device=dev,
                                 dtype=torch.bfloat16) for _ in range(2))
    return source


def _shapes(cfg, max_len: int, policy):
    return T.layer_cache_shapes(cfg, 1, max_len, policy, torch.bfloat16)


def cache_nbytes(cfg, max_len: int, policy) -> int:
    """Bytes of every layer's striped bf16 cache of one slot at capacity
    ``max_len``."""
    return cfg.n_layers * sum(
        math.prod(s) * torch.empty((), dtype=d).element_size()
        for s, d in _shapes(cfg, max_len, policy).values())


def alloc_caches(cfg, max_len: int, policy, device=None):
    """Zeroed layer-stacked caches of one slot under a uniform policy, in
    the tree ``transformer.prefill_model`` returns (``{"scan": {leaf:
    (L, 1, ...)}}``)."""
    dev = resolve_device(device)
    return {"scan": {k: torch.zeros((cfg.n_layers,) + tuple(s), dtype=d,
                                    device=dev)
                     for k, (s, d) in _shapes(cfg, max_len, policy).items()}}


def fill_layer(cache, source: Callable, context: int, policy: QuantPolicy,
               quant_fn: Callable, chunk: int = FILL_CHUNK) -> None:
    """In place: one layer's zeroed striped cache (views are fine) as
    ``kv_cache.prefill`` builds it from the tokens ``[0, context)`` of
    ``source(t0, n)``, drawn ``chunk`` tokens at a time: the sinks from
    the first tokens, the fp window ring from the last, the packed region
    quantized by ``quant_fn`` (one call a plane a chunk; each token row is
    quantized on its own, so the chunking changes no byte), the length
    set to ``context``."""
    cache["length"].fill_(context)
    ns, w = policy.n_sink, policy.window
    lo = max(ns, context - w)            # the ring holds [lo, context)
    qc = max(0, context - ns - w)        # packed tokens [ns, ns + qc)
    for t0 in range(0, context, chunk):
        n = min(chunk, context - t0)
        t1 = t0 + n
        k, v = source(t0, n)
        if policy.is_fp16:
            cache["k"][:, t0:t1] = k
            cache["v"][:, t0:t1] = v
            continue
        if t0 < ns:
            e = min(ns, t1)
            cache["sink_k"][:, t0:e] = k[:, :e - t0]
            cache["sink_v"][:, t0:e] = v[:, :e - t0]
        if w > 0 and lo < context and t1 > lo:
            a = max(t0, lo)
            slots = (torch.arange(a, t1, device=k.device) - ns) % w
            cache["win_k"][:, slots] = k[:, a - t0:]
            cache["win_v"][:, slots] = v[:, a - t0:]
        a, e = max(t0, ns), min(t1, ns + qc)
        if a < e:
            gsz = min(policy.group_size, k.shape[-1])
            for name, x, bits in (("qk", k, policy.bits_k),
                                  ("qv", v, policy.bits_v)):
                qt = quant_fn(x[:, a - t0:e - t0], bits, gsz, None,
                              policy.fp8_meta)
                for kk, vv in qt.items():
                    cache[f"{name}_{kk}"][:, a - ns:e - ns] = vv


def fill_caches(cfg, policy, context: int, max_len: int, source: Callable,
                *, chunk: int = FILL_CHUNK, device=None):
    """Every layer's cache of one slot under a uniform ``policy`` at
    capacity ``max_len``, filled to ``context`` tokens from
    ``source(layer, t0, n)`` (e.g. :func:`seeded_kv`) one layer and
    ``chunk`` tokens at a time (:func:`fill_layer`), in the tree
    ``prefill_model`` returns; identity calibration.  The quantizer is
    the bulk ``kv_quant`` kernel (``kernels.ops.make_kernel_quant_fn``;
    its plain version on the CPU)."""
    from ..kernels.ops import make_kernel_quant_fn
    if context > max_len:
        raise ValueError(f"context {context} exceeds max_len {max_len}")
    qf = make_kernel_quant_fn()
    caches = alloc_caches(cfg, max_len, policy, device)
    for layer in range(cfg.n_layers):
        view = {k: t[layer] for k, t in caches["scan"].items()}
        fill_layer(view, lambda t0, n, _l=layer: source(_l, t0, n), context,
                   policy, qf, chunk)
    return caches


# ------------------------------------------------------ the fp16 yardstick

@dataclasses.dataclass(frozen=True)
class SdpaBackend(CudaBackend):
    """An fp16 cache attended by one ``scaled_dot_product_attention``
    launch a layer over the bf16 tokens (masked past each slot's length):
    the library yardstick of the fp16 rows.  Quantized policies refuse."""

    name: str = "sdpa"

    def attend(self, q, cache, cfg, policy, *, window=None,
               dtype=torch.bfloat16, **levers):
        from ..models.attention import _scale
        if not policy.is_fp16 or window or cfg.attn_softcap:
            raise ValueError("SdpaBackend attends fp16 caches of global "
                             "layers without softcap only")
        b, _, hq, d = q.shape
        k, v = cache["k"], cache["v"]
        lens = slot_lengths(cache, b)
        ok = torch.arange(k.shape[1], device=q.device)[None] < lens[:, None]
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2).to(k.dtype), k.transpose(1, 2),
            v.transpose(1, 2), attn_mask=ok[:, None, None, :],
            scale=_scale(cfg), enable_gqa=hq != k.shape[2])
        return out.transpose(1, 2).to(q.dtype)


# ------------------------------------------------------- measured rows

def _free_bytes(device) -> Optional[int]:
    """Bytes the allocator can still hand out on the card (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _release():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def step_bound(params, cfg, tok, caches, policy, backend) -> dict:
    """The least time of one decode step on the card (``launch.op_cost``
    over one eager step: every op's bytes and FLOPs, the kernels by their
    own formula; ``launch.roofline``'s constants)."""
    from ..launch import op_cost as OC
    from ..launch import roofline as RL
    with torch.no_grad(), OC.OpCounter() as c:
        T.decode_step(params, cfg, tok, caches, policy, backend=backend)
    rl = RL.from_counts(c.totals())
    return {"bound_ms": rl.bound_time * 1e3, "bound_by": rl.dominant,
            "bytes": c.totals()["bytes"], "flops": c.totals()["flops"]}


def measure(params, cfg, policy, context: int, *, device=None,
            backend=None, replays: int = REPLAYS, repeats: int = REPEATS,
            probe: Optional[Callable] = None) -> dict:
    """One measured row at batch 1: caches of ``policy`` filled to
    ``context`` tokens (:func:`fill_caches`, :func:`seeded_kv` from seed
    0; :data:`FILL_CHUNK` tokens at a time, :data:`FP16_FILL_CHUNK` for
    fp16), then one untimed eager step and :data:`EAGER_STEPS` timed ones
    (host-synced wall ms each), one step captured as a CUDA
    graph (``serving.warmup.GraphCache``; nothing is captured on the CPU,
    where the calls run eagerly) and ``repeats`` timings of ``replays``
    replays, the logits' finiteness and the step's bound
    (:func:`step_bound`).  On the card it reads the memory allocated when
    the row begins (``base_mem_bytes``) and once the cache is filled
    (``step_base_mem_bytes``), the fill's peak (``fill_peak_mem_bytes``)
    and the steps' peak (``step_peak_mem_bytes``), the larger of the two
    as ``peak_mem_bytes``.  ``probe``, if given, is called on the filled
    caches between the fill's reading and the steps' and its result kept
    under ``"probe"``: its memory counts in neither.  Every step appends a token (the
    caches hold ``HEADROOM`` more).  A row whose caches exceed the free
    device memory, or whose fill or step runs out of it, comes back with
    ``fits`` False and the bytes it needed.  The row names its device:
    on the CPU its times are host times of the plain versions."""
    from ..serving.warmup import GraphCache
    dev = resolve_device(device)
    max_len = context + HEADROOM
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    need = cache_nbytes(cfg, max_len, policy)
    row = {"device": str(dev), "context": context, "batch": 1,
           "max_len": max_len,
           "cache_bytes": need, "weight_bytes": weights,
           "need_bytes": need + weights,
           "backend": getattr(backend, "name", backend)}
    free = _free_bytes(dev)
    row["free_bytes_before"] = free
    if free is not None and need > free:
        return dict(row, fits=False, where="cache")
    caches = graphs = None
    stage = "fill"
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            row["base_mem_bytes"] = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        caches = fill_caches(cfg, policy, context, max_len,
                             seeded_kv(cfg, 0, dev),
                             chunk=(FP16_FILL_CHUNK if policy.is_fp16
                                    else FILL_CHUNK), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            row["fill_peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        row["fill_s"] = time.perf_counter() - t0
        if probe is not None:
            row["probe"] = probe(caches)
        if dev.type == "cuda":        # the steps' peak, from the filled cache
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            row["step_base_mem_bytes"] = torch.cuda.memory_allocated(dev)
        stage = "step"
        tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)

        def step(tok):
            return T.decode_step(params, cfg, tok, caches, policy,
                                 backend=backend)[0]
        with torch.no_grad():
            step(tok)                     # first use: cuBLAS, allocator
            eager = [C.host_ms(lambda: step(tok), dev)
                     for _ in range(EAGER_STEPS)]
            graphs = GraphCache(dev)
            row["capture_s"] = graphs.warm("decode_step", step, (tok,))
            replay = lambda: graphs.call("decode_step", step, tok)
            row["replayed_ms"] = C.timed(replay, dev, iters=replays,
                                         repeats=repeats, warmup=1)
            logits = replay().float()
            row["finite"] = bool(torch.isfinite(logits).all())
            row["eager_ms"] = C.spread(eager)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                row["step_peak_mem_bytes"] = \
                    torch.cuda.max_memory_allocated(dev)
                row["peak_mem_bytes"] = max(row["fill_peak_mem_bytes"],
                                            row["step_peak_mem_bytes"])
            row.update(step_bound(params, cfg, tok, caches, policy, backend))
        row["length_after"] = int(caches["scan"]["length"][0, 0])
        row["bound_share"] = row["bound_ms"] / row["replayed_ms"]["mean"]
        row["fits"] = True
    except torch.cuda.OutOfMemoryError:
        row.update(fits=False, where=stage)
    finally:
        del caches, graphs
        _release()
    return row


# (label, policy, backend) of the measured rows: kv2 and kv4 on the
# kernels, fp16 on the port's route and on SDPA
POLICIES = (("kv2", PAPER_POLICY, "cuda"), ("kv4", KV4, "cuda"),
            ("fp16", FP16_POLICY, "cuda"),
            ("fp16_sdpa", FP16_POLICY, SdpaBackend()))


def analytic_ms(label: str, context: int) -> float:
    """The analytic row's llama2-7b step (ms) at batch 1 for a measured
    row's label (both fp16 rows: the reference's fp16)."""
    pol = {"kv2": PAPER_POLICY, "kv4": KV4}.get(label)
    return decode_step_time(configs.get(ARCH), 1, context, pol,
                            N_PARAMS)[0] * 1e3


def measured_row(emit, label: str, r: dict, analytic: Optional[float]):
    """Emit one measured row: replayed us a step, then its fields
    (``analytic``: the analytic row's ms, or None)."""
    name = f"table6_measured_b{r['batch']}_s{r['context']}_{label}"
    if not r["fits"]:
        emit(C.csv_row(name, 0.0, f"fits=false,where={r['where']},"
                                  f"need_bytes={r['need_bytes']},"
                                  f"cache_bytes={r['cache_bytes']},"
                                  f"free_bytes={r['free_bytes_before']},"
                                  f"device={r['device']}"))
        return
    rp, eg = r["replayed_ms"], r["eager_ms"]
    peak = r.get("peak_mem_bytes")
    temp = (r["step_peak_mem_bytes"] - r["step_base_mem_bytes"]
            if peak is not None else "n/a")   # the steps' own temporaries
    emit(C.csv_row(
        name, rp["mean"] * 1e3,
        f"fits=true,replayed_ms={rp['mean']:.4f},"
        f"replayed_min_ms={rp['min']:.4f},replayed_max_ms={rp['max']:.4f},"
        f"eager_ms={eg['mean']:.3f},eager_min_ms={eg['min']:.3f},"
        f"eager_max_ms={eg['max']:.3f},"
        f"peak_mem={'n/a' if peak is None else f'{peak / 2**30:.2f}GiB'},"
        f"peak_mem_bytes={peak},step_temp_bytes={temp},"
        f"cache_bytes={r['cache_bytes']},bound_ms={r['bound_ms']:.4f},"
        f"bound_by={r['bound_by']},"
        f"bound_share={r['bound_share']:.3f},"
        f"analytic_ms={'n/a' if analytic is None else f'{analytic:.3f}'},"
        f"fill_s={r['fill_s']:.2f},finite={r['finite']},"
        f"device={r['device']}"))


def run_measured(emit, params, cfg, contexts: Sequence[int], *, device,
                 headline: Optional[int] = None) -> dict:
    """The measured twins at batch 1 for ``contexts`` (every policy of
    :data:`POLICIES`) and, if given, the ``headline`` context at
    ``PAPER_POLICY``; then one speedup row a context whose kv2 row fits.
    Returns ``{(context, label): row}``."""
    full = cfg == configs.get(ARCH)          # the analytic rows' model
    out = {}
    plan = [(s, lab, pol, bk) for s in contexts
            for lab, pol, bk in POLICIES]
    if headline:
        plan.append((headline, "kv2", PAPER_POLICY, "cuda"))
    for s, lab, pol, bk in plan:
        r = measure(params, cfg, pol, s, device=device, backend=bk)
        out[(s, lab)] = r
        measured_row(emit, lab, r, analytic_ms(lab, s) if full else None)
    for s in sorted({s for s, _ in out}):
        got = {lab: out.get((s, lab)) for lab in ("kv2", "fp16",
                                                  "fp16_sdpa")}
        kv2 = got["kv2"]
        if kv2 is None or not kv2["fits"]:
            continue
        t2 = kv2["replayed_ms"]["mean"]
        parts = [f"device={kv2['device']}", f"kv2_ms={t2:.4f}"]
        for lab in ("fp16", "fp16_sdpa"):
            r = got[lab]
            parts.append(f"{lab}_ms=" + (f"{r['replayed_ms']['mean']:.4f}"
                                         if r and r["fits"] else "n/a"))
            parts.append(f"speedup_vs_{lab}=" + (
                f"{r['replayed_ms']['mean'] / t2:.2f}x"
                if r and r["fits"] else "n/a"))
        if full:
            sp = analytic_ms("fp16", s) / analytic_ms("kv2", s)
            parts.append(f"analytic_speedup={sp:.2f}x")
        emit(C.csv_row(f"table6_measured_speedup_b1_s{s}", t2 * 1e3,
                       ",".join(parts)))
    return out


def run(emit, smoke: bool = False, device=None):
    """The analytic rows, then the measured ones: on the card llama2-7b
    at full width at :data:`CONTEXTS` (the first only with ``smoke``) and
    the 1,048,576-token headline; on the CPU the smoke config at
    :data:`SMOKE_CONTEXTS`."""
    dev = resolve_device(device)
    analytic_rows(emit)
    if dev.type == "cuda":
        cfg = configs.get(ARCH)
        contexts, headline = (CONTEXTS[:1] if smoke else CONTEXTS), HEADLINE
    else:
        cfg = configs.get_smoke(ARCH)
        contexts, headline = SMOKE_CONTEXTS, None
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    try:
        rows = run_measured(emit, params, cfg, contexts, device=dev,
                            headline=headline)
    finally:
        del params
        _release()
    return rows
