"""Device meshes of the port (port of ``repro.launch.mesh``) over
``torch.distributed``'s ``DeviceMesh``.

Functions, so that importing this module touches no process group.  A
mesh needs the default process group (``torch.distributed``, NCCL for
CUDA, gloo for the CPU) with one rank a mesh position: :func:`init_world`
starts it from ``torchrun``'s environment or from an address given.
Rank ``r`` sits at the mesh coordinates of ``r`` laid out row-major over
the shape, the layout of JAX's device array at the same shape.  Each
entry point's device is explicit: CUDA by default (raising without a
card), the CPU when asked for.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def backend_for(dev: torch.device) -> str:
    """The process-group backend of a device type: NCCL on CUDA, gloo on
    the CPU."""
    return "nccl" if dev.type == "cuda" else "gloo"


def init_world(device=None, *, init_method: str = "env://",
               world_size: int = -1, rank: int = -1,
               backend: str = None) -> torch.device:
    """Start the default process group if it is not up: from
    ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` by default, or at ``init_method`` (such as
    ``tcp://localhost:<port>``) with ``world_size`` and ``rank``.  The
    backend is the device's (:func:`backend_for`) unless given.  On CUDA
    the rank's card is ``LOCAL_RANK`` modulo the cards there are.
    Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or backend_for(dev),
                                init_method=init_method,
                                world_size=world_size, rank=rank)
    return dev


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world, which
    must hold exactly ``prod(shape)`` ranks, on ``device``'s type (CUDA
    by default: raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 = 256 ranks per pod; multi-pod prepends a 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device=None):
    """``(world, 1)`` over ``("data", "model")``: data parallel over every
    rank of the world (:func:`init_world` first)."""
    resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh spans the process group's "
                           "world: call init_world first")
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
