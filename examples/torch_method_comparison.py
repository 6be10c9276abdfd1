"""Reproduce the paper's method comparison interactively (Table 1 shape) on
the PyTorch + CUDA port: FP16 / RTN / SmoothQuant / RPTQ / KIVI / SKVQ on one
trained model.

    PYTHONPATH=src python examples/torch_method_comparison.py      # on the card
    PYTHONPATH=src python examples/torch_method_comparison.py --device cpu

The model is the quality studies' stand-in (``repro_torch.quality.common``),
trained ``--steps`` steps and cached in ``--cache-dir``; on the card every
fake quantization (the methods and the calibration's clip search) runs on
the bulk kv_quant kernel, on the CPU on its plain version.
(examples/method_comparison.py is the same comparison on the JAX package.)
"""
import argparse

from repro_torch.core.baselines import METHODS
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.quality import common as C
from repro_torch.quality.quality_ladder import ORDER

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=C.TRAIN_STEPS)
ap.add_argument("--cache-dir", default=None,
                help="the model's checkpoint directory (default "
                     "experiments/bench_model_torch; give one directory a "
                     "step count)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg, params, corpus = C.bench_model(args.cache_dir, dev, args.steps)
toks = C.eval_tokens(corpus, device=dev)
pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=16, window=32, n_sink=5)
calibs = C.calibrate(cfg, params, corpus, pol)

print(f"{'method':14s} ppl    (K2V2 g16 w32, synthetic-corpus stand-in "
      f"for LongBench; {args.steps} training steps, {dev.type})")
for name in ORDER:
    ppl = C.ppl_with_method(params, cfg, toks, METHODS[name],
                            calibs=calibs, policy=pol)
    print(f"{name:14s} {ppl:.3f}")
