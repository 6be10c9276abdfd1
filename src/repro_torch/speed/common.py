"""Shared pieces of the speed suites (counterpart of the timing side of
``benchmarks/common.py``): the harness's ``name,us_per_call,derived`` row,
the card line, and one timer that gives device time on the card and host
time on the CPU, each with its spread.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch

HEADER = "name,us_per_call,derived"
HOLD_CYCLES = 20_000_000         # ~10 ms of sleep while calls are queued


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    """One row of the reference harness (``benchmarks/common.py:217``)."""
    return f"{name},{us_per_call:.1f},{derived}"


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def spread(xs: Sequence[float]) -> Dict[str, float]:
    """n, mean, min, max and standard deviation of ``xs``."""
    a = np.asarray(xs, dtype=np.float64)
    return {"n": int(a.size), "mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "std": float(a.std())}


Fns = Union[Callable[[], object], Sequence[Callable[[], object]]]


def cuda_ms(fns: Fns, iters: int = 20, warmup: int = 3,
            hold: int = HOLD_CYCLES) -> float:
    """Mean CUDA-event device time of ``iters`` back-to-back calls, rotating
    over ``fns`` (one callable, or one per copy of the inputs: copies whose
    sum exceeds the 50 MB L2 make every call read device memory, as each
    layer of a decode step reads its own cache).  A sleep kernel of
    ``hold`` cycles holds the stream while the host queues the calls, so
    the time is the device's and not the host's launch rate."""
    fns = [fns] if callable(fns) else list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[], object], device) -> float:
    """Wall ms of one call, the device synchronized before and after (an
    eager step is host-bound: its device time is its host time)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def timed(fns: Fns, device, iters: int = 10, repeats: int = 3,
          warmup: int = 3) -> Dict[str, float]:
    """ms a call with its spread over ``repeats`` timings of ``iters``
    calls: device time (:func:`cuda_ms`) on the card, host time on the
    CPU (where the plain versions run)."""
    if torch.device(device).type == "cuda":
        return spread([cuda_ms(fns, iters, warmup if r == 0 else 0)
                       for r in range(repeats)])
    fns = [fns] if callable(fns) else list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return spread(out)
