"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: the weights, and the K/V that fill a decode
cell's caches.  Everything is drawn on the device in the type it is
served in (bf16), one large call per leaf."""
from __future__ import annotations

from typing import Dict

import torch

from .seeds import sub_seed


def draw_weights(specs: Dict[str, tuple], seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """``specs`` ``{"path/to/leaf": (shape, scale)}`` -> the nested weight
    tree: a normal draw times ``scale``, or zeros for scale 0 (the norms'
    ``(1 + w)`` gains).  Each leaf has its own stream, so one leaf's draw
    never depends on another's."""
    tree: dict = {}
    for path, (shape, scale) in specs.items():
        if scale == 0:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            g = torch.Generator(device=device).manual_seed(
                sub_seed(seed, "weight", path))
            leaf = torch.randn(shape, generator=g, dtype=dtype,
                               device=device)
            leaf.mul_(scale)
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def prefix_kv(seed: int, slot: int, layer: int, n: int, n_kv: int,
              head_dim: int, device, dtype=torch.bfloat16) -> tuple:
    """The K and V of a decode session's first ``n`` tokens in one layer,
    (1, n, Hkv, D) each, unit normal: what a prefill of that session
    would have left, drawn instead of computed."""
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "prefix_kv", slot, layer))
    kv = torch.randn((2, 1, n, n_kv, head_dim), generator=g, dtype=dtype,
                     device=device)
    return kv[0], kv[1]


def tree_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [x for v in tree.values() for x in tree_leaves(v)]
