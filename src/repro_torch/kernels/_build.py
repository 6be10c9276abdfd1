"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``lib<name>.so``, loaded with ``ctypes``.
All sources build at first use, in parallel (one ``nvcc`` per source,
started together; a second caller waits for a build in progress), into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout; the hash covers the sources and the flags, so an edited
source rebuilds and an unchanged one is reused.  ``REPRO_TORCH_BUILD_DIR``
overrides the directory.  Nothing is downloaded.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``; without it the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("kv_quant", "decode_attn", "spans")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILDING = threading.Lock()     # one build at a time in a process
BUILD_INFO: Dict[str, object] = {"dir": None, "ptxas": {}}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    for c in cands + ["/usr/local/cuda/bin/nvcc"]:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "repro_torch CUDA kernels are compiled from csrc/ at first use and "
        "need the CUDA toolkit")


def build_dir() -> Path:
    """Directory keyed by a hash of every source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else \
        Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
    return base / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source missing from the build directory, all ``nvcc``
    processes started together; returns the directory.  A call made while
    another thread builds waits for that build and reuses it."""
    with _BUILDING:
        return _build_missing()


def _build_missing() -> Path:
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").is_file()]
    BUILD_INFO["dir"] = str(out)
    if not todo:
        return out
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO["ptxas"][name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out / f"lib{name}.so")   # atomic: racing builds agree
        (out / f"{name}.log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, building all sources first
    if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
