"""Device resolution for every entry point of the port.

The port is written for the card: ``device=None`` means CUDA, and asking
for CUDA on a host without one raises instead of quietly running on the
CPU.  Tests and CPU rehearsals pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the GPU by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want cuda or cpu")
    return dev
