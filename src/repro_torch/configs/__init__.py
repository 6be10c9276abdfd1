"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only the configurations the port runs are here (the dense llama/granite/
gemma stacks, the qwen2-vl decoder, the deepseek/granite MoE models, the
hymba hybrid, the RWKV6 ``ssm`` model and the seamless-m4t
encoder-decoder); each module is a copy
of its counterpart in ``repro.configs``.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCHS = ("llama3p2_1b", "llama2_7b", "granite_8b", "gemma2_27b",
         "gemma3_4b", "qwen2_vl_7b", "deepseek_moe_16b",
         "granite_moe_1b_a400m", "hymba_1p5b", "seamless_m4t_large_v2",
         "rwkv6_3b")
ALIASES = {"llama3.2-1b": "llama3p2_1b", "llama2-7b": "llama2_7b",
           "granite-8b": "granite_8b", "gemma2-27b": "gemma2_27b",
           "gemma3-4b": "gemma3_4b", "qwen2-vl-7b": "qwen2_vl_7b",
           "deepseek-moe-16b": "deepseek_moe_16b",
           "granite-moe-1b-a400m": "granite_moe_1b_a400m",
           "hymba-1.5b": "hymba_1p5b",
           "seamless-m4t-large-v2": "seamless_m4t_large_v2",
           "rwkv6-3b": "rwkv6_3b"}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
