"""Closed-loop serving CLI of the port (subset of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch llama2_7b [--smoke] [--device cpu]

Builds random params from a seed (bf16 on the card, f32 on the CPU), the
paper-style policy from the flags, and serves ``--requests`` seeded-prompt
requests (default: two admission waves of ``--batch`` slots) through the
port's :class:`~repro_torch.serving.Engine`, then prints the latency and
time-to-first-token percentiles the reference CLI prints.  Without
``--device cpu`` it runs on the GPU and raises if there is none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core.policy import QuantPolicy
from ..core.quant import packed_nbytes
from ..device import resolve_device
from ..kernels import launch_counts
from ..models import transformer as T
from ..serving import Engine, Request


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: 2x batch — two waves)")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--prompt-jitter", type=int, default=0,
                    help="prompt length drawn from prompt-len ± jitter")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="base max_new per request")
    ap.add_argument("--max-new-jitter", type=int, default=0,
                    help="max_new drawn from new-tokens ± jitter")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop generation at this token id")
    ap.add_argument("--bits-k", type=float, default=2.0)
    ap.add_argument("--bits-v", type=float, default=1.5)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--sinks", type=int, default=5)
    ap.add_argument("--backend", default=None,
                    help="cuda | reference (default: cuda on a card)")
    ap.add_argument("--steps-per-sync", type=int, default=8,
                    help="decode tokens per host sync")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    is_fp16 = args.bits_k >= 16 and args.bits_v >= 16
    policy = QuantPolicy(bits_k=args.bits_k, bits_v=args.bits_v,
                         group_size=min(args.group_size, cfg.head_dim),
                         window=0 if is_fp16 else args.window,
                         n_sink=0 if is_fp16 else args.sinks)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = T.init_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    n_req = args.requests or 2 * args.batch
    rng = np.random.default_rng(args.seed)
    jit = args.max_new_jitter
    reqs = []
    for i in range(n_req):
        max_new = max(1, args.new_tokens + (int(rng.integers(-jit, jit + 1))
                                            if jit else 0))
        plen = args.prompt_len
        if args.prompt_jitter:
            plen = max(1, plen + int(rng.integers(-args.prompt_jitter,
                                                  args.prompt_jitter + 1)))
        prompt = np.random.default_rng(i).integers(0, cfg.vocab_size, plen)
        reqs.append(Request(prompt=prompt, max_new=max_new,
                            temperature=args.temperature, eos_id=args.eos_id,
                            seed=i))
    max_len = (args.prompt_len + args.prompt_jitter + args.new_tokens + jit
               + args.steps_per_sync)
    eng = Engine(params, cfg, policy, batch_slots=args.batch, max_len=max_len,
                 backend=args.backend, steps_per_sync=args.steps_per_sync,
                 device=dev)
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    total = sum(len(h.tokens) for h in handles)
    lat = [(h.finish_time - h.submit_time) * 1e3 for h in handles
           if h.finish_time is not None]
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles
            if h.first_token_time is not None]
    fp16_b = 2 * cfg.head_dim * 2
    q_b = (packed_nbytes(cfg.head_dim, policy.bits_k, policy.group_size,
                         policy.meta_dtype_bits)
           + packed_nbytes(cfg.head_dim, policy.bits_v, policy.group_size,
                           policy.meta_dtype_bits))
    print(f"arch={cfg.name} policy=K{args.bits_k}V{args.bits_v} "
          f"g{policy.group_size} w{policy.window} slots={args.batch} "
          f"requests={n_req} device={dev}")
    info = eng.backend_info
    print(f"backend: name={info['name']} kernels={info['kernels']} "
          f"launches={launch_counts()}")
    print(f"served {n_req} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s aggregate)")
    print(f"latency ms/request: p50={_pct(lat, 50):.0f} "
          f"p90={_pct(lat, 90):.0f} p99={_pct(lat, 99):.0f} "
          f"max={max(lat, default=0):.0f}")
    print(f"time-to-first-token ms: p50={_pct(ttft, 50):.0f} "
          f"p90={_pct(ttft, 90):.0f} p99={_pct(ttft, 99):.0f} "
          f"max={max(ttft, default=0):.0f}")
    print(f"KV bytes/token-head: fp16={fp16_b}  skvq={q_b} "
          f"({fp16_b / q_b:.1f}x compression)")
    if handles[0].tokens:
        print("sample:", handles[0].tokens[:16])
    return handles


if __name__ == "__main__":
    main()
