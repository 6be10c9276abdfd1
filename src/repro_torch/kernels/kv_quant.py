"""Fused clipped group-quantize + bit-pack (port of the TPU kernel
``kv_quant_pallas``, ``src/repro/kernels/kv_quant.py``).

:func:`kv_quant` launches the CUDA kernel ``csrc/kv_quant.cu`` on CUDA
tensors and takes the plain PyTorch version :func:`kv_quant_plain` only
for CPU tensors.  Both are bytes-for-bytes equal to
``core.quant.quantize_groups`` — including the ±448 saturation of FP8
metadata, which the Pallas kernel lacks — so caches built either way are
interchangeable.

What bounds it on an H100, and the design: see the note at the top of
``csrc/kv_quant.cu`` (launch-bound at decode sizes; one block per row, row
staged in shared memory, nothing but packed planes written back).

``LAUNCHES["kernel"]`` counts kernel launches and ``LAUNCHES["plain"]``
calls of the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from ..core.quant import plane_layout, quantize_groups

LAUNCHES = {"kernel": 0, "plain": 0}
_C = ctypes


def kv_quant_plain(x: torch.Tensor, bits: float, group_size: int,
                   alpha: Optional[torch.Tensor] = None,
                   fp8_meta: bool = True) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: ``quantize_groups`` on any device."""
    LAUNCHES["plain"] += 1
    return quantize_groups(x, bits, group_size, alpha, fp8_meta)


def _lib():
    lib = _build.load("kv_quant")
    fn = lib.kv_quant_launch
    if fn.argtypes is None:
        plane = [_C.c_int] * 4 + [_C.c_void_p] * 3
        fn.argtypes = ([_C.c_void_p, _C.c_int, _C.c_void_p, _C.c_int,
                        _C.c_int, _C.c_int, _C.c_int] + plane + plane
                       + [_C.c_int, _C.c_void_p])
        fn.restype = _C.c_int
    return fn


def kv_quant(x: torch.Tensor, bits: float, group_size: int,
             alpha: Optional[torch.Tensor] = None,
             fp8_meta: bool = True) -> Dict[str, torch.Tensor]:
    """x (N, D) tokens -> QTensor dict in the ``core.quant`` layout.

    ``alpha``: None, (G_total,) shared or (N, G_total) per-row clip
    factors.  CUDA tensors launch the kernel (and raise if it fails); CPU
    tensors take :func:`kv_quant_plain`."""
    if x.device.type == "cpu":
        return kv_quant_plain(x, bits, group_size, alpha, fp8_meta)
    if x.device.type != "cuda":
        raise ValueError(f"kv_quant: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"kv_quant wants (N, D) rows, got {tuple(x.shape)}")
    n, d = x.shape
    layout = plane_layout(d, bits, group_size)
    g_total = sum(w // gs for (_, w, _, gs) in layout)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    if alpha is None:
        alpha = torch.ones((g_total,), dtype=torch.float32, device=x.device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    if alpha.ndim < 2:
        alpha = alpha.expand(g_total).contiguous()
        a_stride = 0
    else:
        if tuple(alpha.shape) != (n, g_total):
            raise ValueError(f"per-row alpha must be ({n}, {g_total}), got "
                             f"{tuple(alpha.shape)}")
        alpha = alpha.contiguous()
        a_stride = g_total
    meta_dt = torch.uint8 if fp8_meta else torch.float16
    out, args = {}, []
    for name, (start, width, b, gs) in zip(("hi", "lo"), layout):
        codes = torch.empty((n, width * b // 8), dtype=torch.uint8,
                            device=x.device)
        scale = torch.empty((n, width // gs), dtype=meta_dt, device=x.device)
        zero = torch.empty((n, width // gs), dtype=meta_dt, device=x.device)
        out.update({f"codes_{name}": codes, f"scale_{name}": scale,
                    f"zero_{name}": zero})
        args += [start, width, b, gs, codes.data_ptr(), scale.data_ptr(),
                 zero.data_ptr()]
    if len(layout) == 1:
        args += [0, 0, 8, 1, None, None, None]
    fn = _lib()
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), alpha.data_ptr(),
            a_stride, n, d, len(layout), *args, int(fp8_meta),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "kv_quant")
    LAUNCHES["kernel"] += 1
    return out
