"""Long-context serving on the PyTorch + CUDA port: a long-document
request streams through the request-level Engine next to a short
interactive request; the SKVQ cache memory ledger is what makes the
paper's 1M-token claim work, and per-slot cache lengths are what let the
two coexist in one decode batch.

    PYTHONPATH=src python examples/torch_long_context_serving.py
    PYTHONPATH=src python examples/torch_long_context_serving.py --device cpu

(examples/long_context_serving.py is the same scenario on the JAX
package.)
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch.core.kv_cache import cache_shapes
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import packed_nbytes
from repro_torch.data import SyntheticCorpus, make_passkey_sample
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, Request

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--doc-len", type=int, default=512)
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = configs.get_smoke("gemma3_4b")  # 5:1 local:global family
policy = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=32,
                     n_sink=5)
params = T.init_params(cfg, seed=0, device=dev)
corpus = SyntheticCorpus(cfg.vocab_size, seed=0)

S = args.doc_len
doc, key = make_passkey_sample(corpus, S, key_pos=100,
                               rng=np.random.default_rng(0))

# one engine, two very different requests sharing the decode batch: the
# long document (the paper's workload) and a short chat-sized prompt.
# Per-slot cache lengths mean neither pays for the other's context.
eng = Engine(params, cfg, policy, batch_slots=2, max_len=S + 64, device=dev)
long_req = eng.submit(Request(prompt=doc[:-8], max_new=8))
short_req = eng.submit(Request(prompt=corpus.sample(
    32, np.random.default_rng(1)), max_new=16))
eng.run()
print(f"long request : prefilled {S - 8} tokens, generated "
      f"{len(long_req.tokens)} ({long_req.finish_reason})")
print(f"short request: prefilled 32 tokens, generated "
      f"{len(short_req.tokens)} ({short_req.finish_reason})")

# --- memory ledger (per token-head, exact container sizes) ------------------
hd = cfg.head_dim
fp16 = 2 * hd * 2
q = packed_nbytes(hd, policy.bits_k, policy.group_size, 8) + \
    packed_nbytes(hd, policy.bits_v, policy.group_size, 8)
shapes = cache_shapes(1, S + 64, cfg.n_kv_heads, hd, policy)
total = sum(int(np.prod(s)) * d.itemsize for s, d in shapes.values())
print(f"KV bytes/token-head: fp16={fp16}B skvq={q}B -> {fp16/q:.1f}x "
      f"compression")
print(f"container total for this session: {total/1024:.0f} KiB "
      f"(window {policy.window} + sinks {policy.n_sink} ride fp)")
print("at 7B/500k-token scale this is the difference between 110 GB and "
      "~14 GB of cache — the paper's 1M-context-on-80GB claim.")
