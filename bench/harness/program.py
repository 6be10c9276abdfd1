"""The system under test: the PyTorch + CUDA port ``repro_torch``, driven
through its own entry points.  This is the only harness module that
imports it; the reference and the counts never do.

The configuration file's numbers are what runs: the port's registered
architecture is the base, and every key the file holds replaces the
field it maps to (:data:`FIELDS`)."""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path
from typing import Callable, List

import torch

# configuration-file key -> the port's ArchConfig field
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
          "rms_norm_eps": "norm_eps", "hidden_act": "mlp_act",
          "n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
          "n_shared_experts": "n_shared_experts",
          "moe_intermediate_size": "d_expert",
          "first_k_dense_replace": "first_dense",
          "capacity_factor": "capacity_factor"}


def prepare(root: Path) -> None:
    """Put the checkout's ``src`` first on the import path and keep the
    port's kernel build inside the checkout, at a fixed path."""
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"no repro_torch package under {src}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        root / "build" / "repro_torch_kernels")


def arch_config(cfg: dict):
    from repro_torch import configs
    base = configs.get(cfg["port_arch"])
    if base.family != cfg["family"]:
        raise ValueError(f"{cfg['port_arch']} is family {base.family}, "
                         f"the file says {cfg['family']}")
    return dataclasses.replace(base, **{f: cfg[k] for k, f in FIELDS.items()
                                        if k in cfg})


def policy(cfg: dict):
    from repro_torch.core.policy import QuantPolicy
    if cfg.get("calibration", "identity") != "identity":
        raise ValueError("only identity calibration is run")
    return QuantPolicy(**cfg["policy"])


def check_params(params: dict, arch) -> None:
    """Refuse a weight tree whose leaves are not the port's layout."""
    from repro_torch.models import transformer as T
    want = T.param_shapes(arch)
    have = dict(_flat(params))
    if set(want) != set(have) or any(
            tuple(want[k]) != tuple(have[k].shape) for k in want):
        diff = sorted(set(want) ^ set(have)) or [
            k for k in want if tuple(want[k]) != tuple(have[k].shape)]
        raise ValueError(f"weights do not match the program's layout: "
                         f"{diff[:6]}")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def load_kernels() -> None:
    """Build (first run in a checkout) or load both kernel libraries."""
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        _build.load(name)


def alloc_caches(arch, pol, batch: int, max_len: int, device,
                 dtype) -> dict:
    """Zeroed striped caches ``{"scan": {leaf: (L, B, ...)}}`` of one band
    holding K and V in ``dtype``, as the Engine allocates them."""
    from repro_torch.models import transformer as T
    shapes = T.layer_cache_shapes(arch, batch, max_len, pol, dtype)
    return {"scan": {k: torch.zeros((arch.n_layers,) + tuple(s), dtype=d,
                                    device=device)
                     for k, (s, d) in shapes.items()}}


def fill(caches: dict, arch, pol, context: int,
         source: Callable[[int, int], tuple]) -> None:
    """Every slot's and layer's cache filled to ``context`` tokens from
    ``source(slot, layer) -> (k, v)`` (1, context, Hkv, D) bf16, through
    the port's filler and its bulk ``kv_quant`` quantizer."""
    from repro_torch.kernels.ops import make_kernel_quant_fn
    from repro_torch.speed.memory_latency import fill_layer
    qf = make_kernel_quant_fn()
    scan = caches["scan"]
    batch = scan["length"].shape[1]
    for slot in range(batch):
        for layer in range(arch.n_layers):
            view = {k: t[layer, slot:slot + 1] for k, t in scan.items()}
            k, v = source(slot, layer)
            fill_layer(view, lambda t0, n, k=k, v=v: (k[:, t0:t0 + n],
                                                      v[:, t0:t0 + n]),
                       context, pol, qf, chunk=context)


def round_state(caches: dict, pol, context: int) -> List[torch.Tensor]:
    """Views of every cache region a decode round from ``context`` tokens
    writes: the lengths, sinks and fp window whole, and each packed plane
    from row ``context - window - n_sink`` on, where the first token
    leaving the window lands.  The filled rows below are only read."""
    from repro_torch.core.kv_cache import is_plane_key
    r0 = max(0, context - pol.window - pol.n_sink)
    return [t[:, :, r0:] if is_plane_key(k) else t
            for k, t in caches["scan"].items()]


def decode_step_fn(params, arch, pol, caches) -> Callable:
    """The step the window replays: ``serving.engine.decode_one`` (greedy,
    no EOS) over ``caches`` on the kernels."""
    from repro_torch.serving.engine import decode_one

    def step(token, done, bad, live, temps, eos):
        return decode_one(params, arch, pol, token, caches, done, bad, live,
                          temps, eos, None, backend="cuda")
    return step


def graph_cache(device):
    from repro_torch.serving.warmup import GraphCache
    return GraphCache(device)
