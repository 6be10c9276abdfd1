"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only the dense configurations the port runs are here; each module is a copy
of its counterpart in ``repro.configs``.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCHS = ("llama3p2_1b", "llama2_7b")
ALIASES = {"llama3.2-1b": "llama3p2_1b", "llama2-7b": "llama2_7b"}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
