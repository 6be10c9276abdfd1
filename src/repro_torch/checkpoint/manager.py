"""Fault-tolerant checkpoints: manifest-based and atomic (port of
``repro.checkpoint.manager``), in the reference's on-disk layout, so that
a checkpoint either package writes loads in the other:

    <dir>/step_00000042.tmp-<pid>/   -> written fully, then renamed
    <dir>/step_00000042/
        manifest.json      # step, treedef, per-leaf file, shape, dtype, crc32
        leaf_00000.npy ...
    <dir>/LATEST           # the newest complete step directory's name

The leaves are numbered in ``jax.tree.flatten`` order (keys sorted at
every level, :mod:`repro_torch.tree`).  A crash mid-save never corrupts
the newest complete checkpoint (atomic rename); a leaf whose crc32 does
not match makes the load fall back to the previous checkpoint; the data
cursor (``step``) is part of the state, so the input stream resumes
exactly; :meth:`CheckpointManager.register_preemption_hook` saves on
SIGTERM.

A sharded state (DTensor leaves) is saved whole: every rank gathers each
leaf's full tensor, rank 0 alone writes, so the files are byte-equal to a
one-device save of the same values.  On load the leaves are read on the
host and, where ``shardings`` (a tree of ``NamedSharding``) is given,
laid out on its mesh, as the reference reshards on load (``device_put``
with the new mesh's shardings); without it they move to one device.

bf16 leaves are written as the reference writes them (numpy holds no
bf16: 2-byte void records, manifest dtype ``"bfloat16"``) and loaded as
bf16; the reference's own load raises on such a leaf (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..device import resolve_device
from ..distributed.sharding import is_dtensor
from ..tree import leaves, structure, tree_map, unflatten

_BF16 = "bfloat16"


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host; bf16 as its 2-byte records (numpy has no bf16)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _save(path: str, arr: np.ndarray, bf16: bool) -> None:
    """``np.save``; a bf16 leaf with the header the reference's
    ``np.save`` of an ``ml_dtypes.bfloat16`` array writes (descr
    ``"<V2"``), so the two files are byte-equal."""
    if not bf16:
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's bytes (``arr.tobytes()``), without the copy."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                      ) & 0xFFFFFFFF


def save_checkpoint(directory: str, step: int, state) -> str:
    """Write ``state`` (a nested dict of tensors) as ``step_XXXXXXXX``
    under ``directory``, atomically, and point ``LATEST`` at it.  Returns
    the checkpoint's path.  A state with DTensor leaves is gathered on
    every rank (a collective: each rank calls this) and written by rank 0
    alone; the others wait for it to finish."""
    flat = leaves(state)
    if any(is_dtensor(x) for x in flat):
        state = unflatten(state, [x.full_tensor() if is_dtensor(x) else x
                                  for x in flat])
        path = os.path.join(directory, f"step_{step:08d}")
        if dist.get_rank() == 0:
            path = save_checkpoint(directory, step, state)
        dist.barrier()
        return path
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": structure(state), "leaves": []}
    for i, leaf in enumerate(leaves(state)):
        arr = _to_numpy(leaf)
        bf16 = torch.as_tensor(leaf).dtype == torch.bfloat16
        fname = f"leaf_{i:05d}.npy"
        _save(os.path.join(tmp, fname), arr, bf16)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape),
            "dtype": _BF16 if bf16 else str(arr.dtype), "crc32": _crc(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def _load_one(path: str, verify: bool = True):
    """(manifest, leaves as numpy) of one checkpoint directory; IOError on
    a crc mismatch.  A bf16 leaf comes back as its uint16 bit pattern."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(path, meta["file"]), allow_pickle=False)
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"crc mismatch in {path}/{meta['file']}")
        if meta["dtype"] == _BF16:
            arr = arr.view(np.uint16)
        out.append(arr)
    return manifest, out


def _tensor(arr: np.ndarray, like: torch.Tensor, dev) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if arr.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    return t.to(device=dev, dtype=like.dtype)


def load_latest(directory: str, like, device=None,
                verify: bool = True, shardings=None
                ) -> Optional[Dict[str, Any]]:
    """Walk the checkpoints newest first; return ``{"step", "state"}`` of
    the first complete one whose crc32s match and whose leaf count is
    ``like``'s, or None.  ``like`` gives the structure and each leaf's
    dtype; the leaves are read on the host and moved to ``device`` (CUDA
    by default; raises without a card unless ``"cpu"``), then, with
    ``shardings`` (``like``'s structure, a ``distributed.sharding.
    NamedSharding`` a leaf), laid out on its mesh: each rank keeps its
    shards (reshard on load)."""
    if not os.path.isdir(directory):
        return None
    dev = resolve_device(device)
    want = leaves(like)
    cands = sorted((d for d in os.listdir(directory)
                    if d.startswith("step_") and ".tmp" not in d),
                   reverse=True)
    for cand in cands:
        path = os.path.join(directory, cand)
        try:
            manifest, arrs = _load_one(path, verify)
        except (OSError, EOFError, ValueError, KeyError):
            continue      # corrupt or partial: fall back to the previous
        if len(arrs) != len(want):
            continue
        state = unflatten(like, [_tensor(a, w, dev)
                                 for a, w in zip(arrs, want)])
        if shardings is not None:
            state = tree_map(lambda x, sh: sh.place(x), state, shardings)
        return {"step": manifest["step"], "state": state}
    return None


@dataclasses.dataclass
class CheckpointManager:
    """Periodic saves every ``save_every`` steps, keeping the newest
    ``keep``; resume from the newest valid one."""
    directory: str
    keep: int = 3
    save_every: int = 100

    def maybe_save(self, step: int, state) -> Optional[str]:
        if step % self.save_every != 0:
            return None
        path = save_checkpoint(self.directory, step, state)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._gc()
        return path

    def _gc(self):
        cands = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in cands[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def restore_or_none(self, like, device=None, shardings=None):
        return load_latest(self.directory, like, device,
                           shardings=shardings)

    def register_preemption_hook(self, get_state: Callable[[], tuple]):
        """SIGTERM -> save ``get_state()`` = (step, state) at once
        (cluster preemption)."""

        def handler(signum, frame):
            step, state = get_state()
            save_checkpoint(self.directory, step, state)

        signal.signal(signal.SIGTERM, handler)
