"""Quickstart on the PyTorch + CUDA port: train, calibrate, serve.

    PYTHONPATH=src python examples/torch_quickstart.py            # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. train a small llama-family model through the port's train step;
2. calibrate SKVQ offline (channel reorder + clip factors) on sample text;
3. serve with a 2-bit-K / 1.5-bit-V cache (the decode_attn / kv_quant
   kernels on the card, their plain versions on the CPU) and compare
   against an 8-bit cache.
(examples/quickstart.py is the same walk through the JAX package.)
"""
import argparse
import functools

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import DataLoader, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, Request
from repro_torch.training import (init_train_state, make_train_step,
                                  warmup_cosine)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=120)
args = ap.parse_args()
dev = resolve_device(args.device)

# 1. model (trained briefly so K/V have real channel structure) --------------
cfg = configs.get_smoke("llama3p2_1b")          # --arch llama3.2-1b, reduced
corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
state = init_train_state(cfg, seed=0, device=dev)
step = make_train_step(cfg, lr_fn=functools.partial(
    warmup_cosine, peak_lr=5e-3, warmup=10, total=args.steps))
dl = DataLoader(corpus, batch=16, seq=64, device=dev)
for i in range(args.steps):
    state, m = step(state, dl.batch_at(i))
params = state["params"]
print(f"trained {args.steps} steps, nll {float(m['nll']):.2f}")

# 2. offline calibration (paper Alg. 1 prologue) ------------------------------
policy = QuantPolicy(bits_k=2.0, bits_v=1.5,    # the paper's headline setting
                     group_size=16, window=16, n_sink=4, fp8_meta=True)
calib_toks = torch.from_numpy(np.stack(
    [corpus.sample(128, np.random.default_rng(i)) for i in range(4)])).to(dev)
calib = calibrate_model(lambda: T.collect_kv(params, cfg, calib_toks),
                        policy).stacked(device=dev)
print(f"calibrated {cfg.n_layers} layers "
      f"(avg bits = {policy.avg_bits(cfg.head_dim):.2f} incl. fp8 metadata)")

# 3. serve (request-level engine: submit -> stream -> run) -------------------
# ragged prompts + ragged budgets, chunked prefill in fixed-size buckets
# (DESIGN.md §7): 4 requests over 2 slots, two admission waves
prompts = [corpus.sample(48 + 8 * i, np.random.default_rng(10 + i))
           for i in range(4)]
eng = Engine(params, cfg, policy, batch_slots=2, max_len=160, calib=calib,
             prefill_chunk=16, device=dev)
handles = [eng.submit(Request(prompt=p, max_new=12 + 2 * i))
           for i, p in enumerate(prompts)]
eng.run(handles)
for h in handles:
    print(f"SKVQ request {h.rid}: prompt {len(h.request.prompt):3d} toks -> "
          f"{h.result()[:8]}... ({h.finish_reason})")
print(f"prefill chunk buckets run {eng.prefill_shapes} for "
      f"{len(set(map(len, prompts)))} distinct prompt lengths; "
      f"backend {eng.backend_info['name']}")

eight = QuantPolicy(bits_k=8.0, bits_v=8.0, group_size=16, window=16,
                    n_sink=4, fp8_meta=False)
ref = Engine(params, cfg, eight, batch_slots=2, max_len=160, device=dev)
ref_handles = [ref.submit(Request(prompt=p, max_new=12 + 2 * i))
               for i, p in enumerate(prompts)]
ref.run(ref_handles)
agree = np.mean([np.mean(h.result() == r.result())
                 for h, r in zip(handles, ref_handles)])
print(f"token agreement @2/1.5-bit vs 8-bit: {agree:.0%}")
