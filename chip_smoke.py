#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card

Builds both hand-written kernels from ``src/repro_torch/csrc`` and runs
five phases, each printing one JSON line:

1. env — GPU name and power limit, torch/CUDA versions, kernel build time.
2. kv_quant — the kernel against its plain PyTorch version at the serving
   shapes (and the GQA smoke planes), edge-case rows included: 0 differing
   bytes allowed.  CUDA-event times of both and the memory bound.
3. decode_attn — the kernel against its plain version (f32, atol 3e-5 /
   rtol 1e-4 on the normalized output, m and l), pruned walk bitwise equal
   to the full walk, times, bound, and scaled_dot_product_attention over
   the same tokens dequantized to bf16 as a yardstick.
4. serve — the port's Engine at full llama2-7b width (random bf16 weights
   from a seed), PAPER_POLICY, 8 greedy requests in two admission waves on
   4 slots; asserts every request finishes, launch counts, zero plain-
   version calls, and cuda-vs-reference backend logits on one step.
   Decode step time comes from the Engine's own decode chunks (each one
   ends in a host copy) and from CUDA-event times of single steps, each
   with its spread.
5. the kernel summary line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
ATOL, RTOL = 3e-5, 1e-4          # decode_attn kernel vs plain, f32
LOGIT_REL_TOL = 0.05             # cuda vs reference backend, bf16 model
MAX_LEN = 4096                   # per-slot cache capacity of the serve phase


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """Least time the card could take (ms) and what bounds it: the bytes
    over the HBM rate or the f32 operations over the f32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def phase_env(state):
    import torch
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    res = {}
    for name, log in _build.BUILD_INFO["ptxas"].items():
        res[name] = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
    state["gpu"] = gpu_line()
    emit({"phase": "env", "gpu": state["gpu"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": round(build_s, 3), "build_dir": _build.BUILD_INFO["dir"],
          "ptxas": res})


def _edge_rows(gen, d, dev):
    import torch
    u = lambda lo, hi: torch.rand(d, generator=gen, device=dev) * (hi - lo) + lo
    n = lambda s, m=0.0: torch.randn(d, generator=gen, device=dev) * s + m
    rows = [torch.zeros(d, device=dev), torch.full((d,), 0.5, device=dev),
            torch.full((d,), -3.0, device=dev), u(0.0, 1e-3), u(-2e-4, 2e-4),
            torch.cat([torch.zeros(1, device=dev), u(0.0, 1e-3)[1:]]),
            n(900.0), n(1.0, -1000.0)]
    return torch.stack(rows)


def phase_kv_quant(state):
    import torch
    from repro_torch.core.quant import (dequantize_groups, n_meta_groups,
                                        plane_layout)
    from repro_torch.kernels import kv_quant as KQ
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, worst = [], 0.0
    for d, gs in ((128, 128), (64, 64)):              # llama2-7b, GQA smoke
        for bits in (2.0, 1.5):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((128, d), generator=gen, device=dev)
                x[:8] = _edge_rows(gen, d, dev)
                x = x.to(dtype)
                g = n_meta_groups(d, bits, gs)
                alpha = 0.8 + 0.2 * torch.rand((128, g), generator=gen,
                                               device=dev)
                got = KQ.kv_quant(x, bits, gs, alpha)
                want = KQ.kv_quant_plain(x, bits, gs, alpha)
                diff = sum(int((got[k].view(torch.uint8)
                                != want[k].view(torch.uint8)).sum())
                           for k in want)
                check(diff == 0, f"kv_quant d={d} bits={bits} {dtype}: "
                      f"{diff} bytes differ from the plain version")
                # the same bytes dequantize to the same values: err is 0.0
                deq = [dequantize_groups(qt, d, bits, gs, True, torch.float32)
                       for qt in (got, want)]
                err = float((deq[0] - deq[1]).abs().max())
                worst = max(worst, err)
                ms = cuda_ms(lambda: KQ.kv_quant(x, bits, gs, alpha))
                plain_ms = cuda_ms(lambda: KQ.kv_quant_plain(x, bits, gs,
                                                             alpha))
                out_b = sum(v.numel() * v.element_size() for v in got.values())
                in_b = x.numel() * x.element_size() + alpha.numel() * 4
                # per element: min, max, subtract, divide, round, 2 clamps
                bound_ms, bound_by = bound(in_b + out_b, 7 * x.numel())
                rows.append({"d": d, "bits": bits, "dtype": str(dtype)[6:],
                             "rows": 128, "planes": len(plane_layout(d, bits,
                                                                     gs)),
                             "diff_bytes": diff, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by})
    emit({"phase": "kv_quant", "cases": rows})
    main = rows[0]                       # K plane of a decode step, bf16
    state["kv_quant"] = {"max_abs_err": worst, "ms": main["ms"],
                         "plain_ms": main["plain_ms"],
                         "bound_ms": main["bound_ms"],
                         "bound_by": main["bound_by"]}


def _attn_case(gen, dev, b, hkv, gq, d, live):
    """Packed planes of a ``MAX_LEN``-token cache (the serve phase's: 3963
    packed tokens under a 4096-token mask) with ``live`` packed tokens per
    slot, built by the port's own prefill + masks."""
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.policy import PAPER_POLICY as POL
    from repro_torch.kernels import ops
    from repro_torch.core import segments as seg
    k = torch.randn((b, MAX_LEN, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, MAX_LEN, hkv, d), generator=gen, device=dev)
    cache = kvc.prefill(k.to(torch.bfloat16), v.to(torch.bfloat16), MAX_LEN,
                        POL, quant_fn=ops.make_kernel_quant_fn())
    cache["length"].copy_(torch.tensor(live, device=dev) + POL.n_sink
                          + POL.window)
    lens = cache["length"]
    cap = cache["qk_codes_hi"].shape[1]
    bs, s_pad = ops._block_pad(cap, 256)
    ok = ops._packed_ok(ops._padded_j(cap, s_pad, dev), lens, lens - 1,
                        seg.effective_window(0), POL, b)
    k_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")}
    v_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")}
    q = torch.randn((b, hkv, gq, d), generator=gen, device=dev)
    return (POL, q, k_qt, v_qt, ok.to(torch.float32),
            seg.packed_block_bounds(ok, bs), bs)


def phase_decode_attn(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import dequantize_groups, packed_nbytes
    from repro_torch.kernels import decode_attn as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    live = [500, 1500, 2900, 3900]
    rows = []
    for hkv, gq, d in ((32, 1, 128), (8, 4, 64)):
        pol, q, k_qt, v_qt, mask, bounds, bs = _attn_case(
            gen, dev, 4, hkv, gq, d, live)
        check(int((mask > 0).sum()) == sum(live),
              "decode_attn case: live token count")
        scale = d ** -0.5
        args = (q, k_qt, v_qt, mask, pol, d, scale)
        got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
        want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds)
        full = DA.decode_attn(*args, block_s=bs)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, full)),
              f"decode_attn hkv={hkv}: pruned walk differs from full walk")
        out_g, out_w = got[0] / got[2], want[0] / want[2]
        err = float((out_g - out_w).abs().max())
        for name, a, b in (("out", out_g, out_w), ("m", got[1], want[1]),
                           ("l", got[2], want[2])):
            close = torch.allclose(a, b, atol=ATOL, rtol=RTOL)
            check(close, f"decode_attn hkv={hkv}: {name} outside atol={ATOL}"
                  f" rtol={RTOL}: max err {float((a - b).abs().max())}")
        ms = cuda_ms(lambda: DA.decode_attn(*args, block_s=bs,
                                            block_bounds=bounds))
        plain_ms = cuda_ms(lambda: DA.decode_attn_plain(
            *args, block_s=bs, block_bounds=bounds), iters=3, warmup=1)
        full_ms = cuda_ms(lambda: DA.decode_attn(*args, block_s=bs))
        gsz = min(pol.group_size, d)
        per_tok = hkv * (packed_nbytes(d, pol.bits_k, gsz, 8)
                         + packed_nbytes(d, pol.bits_v, gsz, 8))
        n_live = sum(live)
        nbytes = (n_live * (per_tok + 4) + q.numel() * 4
                  + 4 * hkv * gq * (d + 2))
        # per live token and kv head: dequantize K and V (2 x 2D), then
        # q.k and p.v for each of the Gq query rows (2 x 2D x Gq)
        flops = n_live * hkv * (4 * d + 4 * d * gq)
        bound_ms, bound_by = bound(nbytes, flops)
        # yardstick: SDPA over the same tokens dequantized to bf16, masked
        kd = dequantize_groups(k_qt, d, pol.bits_k, gsz, True, torch.bfloat16)
        vd = dequantize_groups(v_qt, d, pol.bits_v, gsz, True, torch.bfloat16)
        kd, vd = kd.transpose(1, 2), vd.transpose(1, 2)      # B, H, S, D
        qb = q.reshape(4, hkv * gq, 1, d).to(torch.bfloat16)
        am = (mask[:, : kd.shape[2]] > 0)[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(
            qb, kd, vd, attn_mask=am, scale=scale, enable_gqa=gq > 1)
        library_ms = cuda_ms(lib)
        rows.append({"hkv": hkv, "gq": gq, "d": d, "max_len": MAX_LEN,
                     "packed": k_qt["codes_hi"].shape[1],
                     "mask": mask.shape[1], "live": live,
                     "bounds": bounds.tolist(), "max_abs_err": err, "ms": ms,
                     "full_walk_ms": full_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "flops": flops,
                     "library_ms": library_ms})
        del kd, vd
    emit({"phase": "decode_attn", "cases": rows, "atol": ATOL, "rtol": RTOL})
    state["decode_attn"] = {k: rows[0][k] for k in
                            ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}


SERVE_LENS = [1024, 2048, 3000, 512, 1536, 1536, 2500, 1024]  # two waves
SERVE_NEW, SERVE_SLOTS, SERVE_SPS = 64, 4, 16
STEP_CONTEXT, TIMED_STEPS = 2048, 32     # single-step timings: 4 x 2048


def _spread(xs):
    import numpy as np
    a = np.asarray(xs, dtype=np.float64)
    return {"n": int(a.size), "mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "std": float(a.std())}


def phase_serve(state):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, Request
    dev = torch.device("cuda")
    cfg = configs.get("llama2_7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    eng = Engine(params, cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 device=dev)
    # every decode chunk ends in its one device->host copy, so its wall time
    # is that of SERVE_SPS decode steps as the Engine runs them
    chunks = []
    decode_chunk = eng._decode_chunk

    def timed_chunk():
        active = eng.active_slots
        t = time.monotonic()
        decode_chunk()
        chunks.append(((time.monotonic() - t) * 1e3 / SERVE_SPS, active))
    eng._decode_chunk = timed_chunk
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=SERVE_NEW, seed=i)
            for i, n in enumerate(SERVE_LENS)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    steps = eng.n_decode_steps
    check(all(h.finish_reason == "length" and len(h.tokens) == SERVE_NEW
              for h in handles),
          f"not every request finished with length: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "token id out of range")
    check(counts["decode_attn"]["kernel"] == cfg.n_layers * steps,
          f"decode_attn launches {counts['decode_attn']} != layers x steps "
          f"= {cfg.n_layers * steps}")
    check(counts["kv_quant"]["kernel"] >= 2 * cfg.n_layers * steps,
          f"kv_quant launches {counts['kv_quant']} < 2 x layers x steps")
    check(counts["decode_attn"]["plain"] == 0
          and counts["kv_quant"]["plain"] == 0,
          f"the wrong version ran on the main path: {counts}")
    peak = torch.cuda.max_memory_allocated()
    state["launches"] = {k: v["kernel"] for k, v in counts.items()}
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]

    # prefill of the longest prompt alone, synced
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, max(SERVE_LENS))), device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, _ = T.prefill_model(params, cfg, prompt, PAPER_POLICY,
                                calib=eng.calib, max_len=MAX_LEN,
                                backend="cuda")
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    # single decode steps of a 4-slot batch at STEP_CONTEXT, each between
    # two CUDA events; then one step on the cuda and reference backends
    # from the same cache
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    _, base = T.prefill_model(params, cfg, batch, PAPER_POLICY,
                              calib=eng.calib, max_len=MAX_LEN,
                              backend="cuda")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    clone = lambda c: {g: {k: v.clone() for k, v in d.items()}
                       for g, d in c.items()}
    step_caches = clone(base)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TIMED_STEPS + 1)]
    tk = tok
    torch.cuda.synchronize()
    marks[0].record()
    for i in range(TIMED_STEPS):
        lg, step_caches = T.decode_step(params, cfg, tk, step_caches,
                                        PAPER_POLICY, calib=eng.calib,
                                        backend="cuda")
        tk = lg[:, -1].argmax(-1, keepdim=True)
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    prof = _profile_decode(lambda: T.decode_step(
        params, cfg, tok, step_caches, PAPER_POLICY, calib=eng.calib,
        backend="cuda"))
    lc, _ = T.decode_step(params, cfg, tok, clone(base), PAPER_POLICY,
                          calib=eng.calib, backend="cuda")
    lr, _ = T.decode_step(params, cfg, tok, clone(base), PAPER_POLICY,
                          calib=eng.calib, backend="reference")
    lc, lr = lc[:, -1].float(), lr[:, -1].float()
    check(bool(torch.isfinite(lc).all() and torch.isfinite(lr).all()),
          "decode logits not finite")
    rel = float((lc - lr).norm() / lr.norm())
    top1 = float((lc.argmax(-1) == lr.argmax(-1)).float().mean())
    check(rel <= LOGIT_REL_TOL, f"cuda vs reference logits: relative L2 "
          f"{rel:.4f} > {LOGIT_REL_TOL}")
    tokens = sum(len(h.tokens) for h in handles)
    cache_b = T.cache_bytes(eng._caches)
    bf16_b = T.bf16_cache_bytes(cfg, SERVE_SLOTS, MAX_LEN)
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "params_init_s": round(init_s, 3), "requests": len(handles),
          "prompt_lens": SERVE_LENS, "max_new": SERVE_NEW,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "decode_steps": steps, "wall_s": wall,
          "tokens": tokens, "tokens_per_s": tokens / wall,
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "prefill_ms_longest": prefill_ms,
          # the first chunk carries one-time warm-up: the spread is over
          # the others
          "engine_chunk_ms_per_step": [round(ms, 3) for ms, _ in chunks],
          "engine_chunk_active_slots": [n for _, n in chunks],
          "engine_ms_per_step": _spread([ms for ms, _ in chunks[1:]]),
          "single_step_context": STEP_CONTEXT,
          "single_step_ms": _spread(step_ms),
          "launches": counts, "peak_mem_bytes": peak,
          "cache_bytes": cache_b, "bf16_cache_bytes": bf16_b,
          "cache_ratio": cache_b / bf16_b, "logits_rel_l2": rel,
          "logits_rel_tol": LOGIT_REL_TOL, "top1_agreement": top1,
          "decode_profile": prof})


def _profile_decode(step, n: int = 2):
    """Device time by kernel over ``n`` decode steps (torch.profiler):
    busy share of the wall time, launches per step, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:     # kernels only: aten ops
            continue                             # would count them twice
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    dev_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_ms_per_step": dev_us / n / 1e3,
            "device_busy_share": dev_us / wall_us if wall_us else None,
            "kernels_per_step": sum(r[1] for r in rows) / n,
            "top": [{"name": k[:80], "ms_per_step": us / n / 1e3,
                     "calls_per_step": c / n} for us, c, k in rows[:8]]}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    for phase in (phase_env, phase_kv_quant, phase_decode_attn, phase_serve):
        phase(state)
    entries = []
    for name, src, rep in (
            ("decode_attn", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:137"),
            ("kv_quant", "src/repro_torch/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:78")):
        m = state[name]
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": state["launches"][name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m.get("library_ms")})
    emit({"kernels": entries})
    print(state["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
