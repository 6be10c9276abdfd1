"""End-to-end training on the PyTorch + CUDA port: train a (reduced)
model for a few hundred steps with checkpointing + resume + straggler
monitoring through the port's trainer CLI, then hand the weights straight
to SKVQ serving.

    PYTHONPATH=src python examples/torch_train_end_to_end.py
    PYTHONPATH=src python examples/torch_train_end_to_end.py --device cpu

(examples/train_end_to_end.py is the same run through the JAX package;
either trainer resumes the other's checkpoints.)
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import configs
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import SyntheticCorpus
from repro_torch.launch import train as train_cli
from repro_torch.serving import ServeSession

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--ckpt-dir", default=os.path.join(
    tempfile.gettempdir(), "skvq_torch_example_ckpt"))
args = ap.parse_args()
dev = ["--device", args.device] if args.device else []

state = train_cli.main([
    "--arch", "llama3p2_1b", "--smoke", *dev,
    "--steps", str(args.steps), "--batch", "16", "--seq", "128",
    "--lr", "5e-3",
    "--ckpt-dir", args.ckpt_dir, "--save-every", str(max(args.steps // 2, 1)),
])

cfg = configs.get_smoke("llama3p2_1b")
corpus = SyntheticCorpus(cfg.vocab_size, seed=1)
policy = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=16,
                     n_sink=4)
sess = ServeSession(state["params"], cfg, policy, batch_slots=4, max_len=192,
                    device=args.device)
prompts = np.stack([corpus.sample(96, np.random.default_rng(i))
                    for i in range(4)])
out = sess.generate(prompts, max_new=24)
print("served", out.shape, "tokens from the freshly trained checkpoint")
print(out[0])
