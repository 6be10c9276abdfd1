"""Assigned input-shape cells and input specs per (arch, shape) (port of
``repro.configs.shapes``).

Four shape cells per LM arch (40 total):
  train_4k     seq 4096   x global batch 256   -> train_step
  prefill_32k  seq 32768  x global batch 32    -> serve prefill
  decode_32k   one token against a 32768 cache x batch 128 -> serve_step
  long_500k    one token against a 524288 cache x batch 1  -> serve_step
               (sub-quadratic archs only; see SKIPS)

The spec functions return meta tensors (``device="meta"``: a shape and a
dtype, no storage), where the reference returns ``jax.ShapeDtypeStruct``s:
the stand-ins the dry-run (``launch.dryrun``) lays out and traces
against.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.config import ArchConfig

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k runs only for sub-quadratic archs (SSM / hybrid / local-attention
# alternation); pure full-attention archs are skipped per the assignment.
LONG_OK = ("rwkv6_3b", "hymba_1p5b", "gemma2_27b", "gemma3_4b")

SKIPS: Dict[Tuple[str, str], str] = {
    (a, "long_500k"): "pure full-attention arch — long_500k skipped (DESIGN.md)"
    for a in ("llama3p2_1b", "granite_8b", "qwen2_vl_7b", "deepseek_moe_16b",
              "granite_moe_1b_a400m", "seamless_m4t_large_v2", "llama2_7b")
}


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    return SKIPS.get((arch, shape))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _inputs(cfg: ArchConfig, b: int, sl: int, dtype) -> Dict:
    batch: Dict = {}
    if cfg.input_embeds:
        batch["embeds"] = _sds((b, sl, cfg.d_model), dtype)
        if cfg.mrope_sections:
            batch["positions"] = _sds((3, b, sl), torch.int32)
    else:
        batch["tokens"] = _sds((b, sl), torch.int32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _sds((b, min(cfg.enc_seq_len, sl),
                                    cfg.d_model), dtype)
    return batch


def train_input_specs(cfg: ArchConfig, shape: str,
                      dtype=torch.bfloat16) -> Dict:
    s = SHAPES[shape]
    b, sl = s["global_batch"], s["seq_len"]
    return {"labels": _sds((b, sl), torch.int32), **_inputs(cfg, b, sl,
                                                            dtype)}


def prefill_input_specs(cfg: ArchConfig, shape: str,
                        dtype=torch.bfloat16) -> Dict:
    s = SHAPES[shape]
    return _inputs(cfg, s["global_batch"], s["seq_len"], dtype)


def decode_token_spec(cfg: ArchConfig, shape: str, dtype=torch.bfloat16):
    b = SHAPES[shape]["global_batch"]
    if cfg.input_embeds:
        return _sds((b, 1, cfg.d_model), dtype)
    return _sds((b, 1), torch.int32)


# prompt tokens the cache-spec prefill runs (see decode_cache_specs)
SPEC_PROMPT = 256


def decode_cache_specs(cfg: ArchConfig, shape: str, policy, calib=None,
                       dtype=torch.bfloat16):
    """Cache specs (meta tensors) from the port's own ``prefill_model``
    run under ``FakeTensorMode`` (the reference's ``jax.eval_shape`` of
    its prefill): the tree is exactly what serving produces, and nothing
    is computed or allocated.  The params are fake tensors of
    ``transformer.param_shapes`` in ``dtype``.

    A cache's leaves are shaped by its capacity (``serve_max_len``), the
    batch and the model, never by the prompt's length, so the prefill runs
    ``SPEC_PROMPT`` tokens of each prompt (the encoder frames of an
    enc-dec cell whole) at the cell's capacity: the tree equals the
    full-length prompt's (held to the reference's ``eval_shape`` in the
    tests), and the trace takes ~1/128 of the ops a 32k-token prefill
    would."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import transformer as T
    from ..tree import tree_map
    sl = SHAPES[shape]["seq_len"]
    ml = serve_max_len(sl, policy)
    n = min(sl, SPEC_PROMPT)
    with FakeTensorMode(), torch.no_grad():
        params = fake_params(cfg, dtype)
        batch = {}
        for k, v in prefill_input_specs(cfg, shape, dtype).items():
            shape_ = list(v.shape)
            if k in ("tokens", "embeds"):
                shape_[1] = n
            elif k == "positions":
                shape_[2] = n
            batch[k] = torch.zeros(shape_, dtype=v.dtype)
        _, caches = T.prefill_model(
            params, cfg, batch.get("tokens"), policy, calib=calib,
            max_len=ml, dtype=dtype, backend="reference",
            embeds=batch.get("embeds"), positions=batch.get("positions"),
            enc_embeds=batch.get("enc_embeds"))
    return tree_map(lambda x: _sds(x.shape, x.dtype), caches)


def fake_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict:
    """A params tree of ``transformer.param_shapes`` as empty tensors in
    ``dtype`` (inside ``FakeTensorMode``: fake tensors, no storage)."""
    from ..models import transformer as T
    params: Dict = {}
    for path, shape in T.param_shapes(cfg).items():
        *parents, name = path.split("/")
        node = params
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.empty(shape, dtype=dtype)
    return params


def serve_max_len(seq_len: int, policy) -> int:
    """Cache capacity: the packed region holds exactly ``seq_len`` slots
    (keeps it power-of-two for clean context-parallel sharding); window and
    sinks ride on top as extra fp capacity."""
    return seq_len + policy.n_sink + policy.window
