"""One run of one cell: the state a driver works from, and what it hands
back.

:func:`run_cell` loads the cell's files, builds a :class:`Run`, calls the
cell's driver, reads the per-layer metrics from the traced slice in a
``--trace 1`` run, and assembles the result line's object.  ``device``,
``overrides`` and ``fault`` exist for the CPU tests: they run a cell at a
smoke size on the plain versions of the kernels, and plant faults in the
program to see ``correct`` come out false."""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import manifest, program
from .tracing import Tracer

GUARDED = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``); 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Check:
    """One number compared with its limit: the run is correct only if
    every ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: manifest.Cell
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    device: object
    tracer: Tracer
    t0: float                         # the clock at process start
    fault: Optional[Callable] = None  # tests: plants a fault in the program
    control: bool = False             # also read the control's gap
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    def clock(self) -> float:
        return time.perf_counter()

    def setup_done(self) -> float:
        """Seconds from process start to now, the device drained: the
        run's ``setup_s``."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        return self.clock() - self.t0

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def reference(self):
        return self.cell.reference()


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer_ctx: Dict[str, object]


def loaded_guarded() -> List[str]:
    """Top-level module names in ``sys.modules`` that are the JAX stack or
    the JAX package (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in GUARDED})


def free_device_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, root: Path = manifest.ROOT,
             overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, control: bool = False,
             notes: bool = False, t0: Optional[float] = None) -> dict:
    """Run the cell once; returns the result line's object.  ``control``
    also runs the control; ``notes`` adds the cell driver's notes (the gaps'
    statistics, the control's) under ``"notes"``: both for
    ``bench/probe.py``."""
    import torch
    cell = manifest.Cell(manifest.load_manifest(root / "BENCHMARK.json"),
                         workload, root)
    program.prepare(root)
    cfg = dict(cell.config)
    traffic = dict(cell.traffic)
    for key, target in (("config", cfg), ("traffic", traffic)):
        target.update((overrides or {}).get(key, {}))
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed),
              seconds=float(seconds), device=dev,
              tracer=Tracer(bool(trace) and dev.type == "cuda"),
              t0=t0 if t0 is not None else time.perf_counter(),
              fault=fault, control=control)
    out: Outcome = cell.driver().run(run)
    if trace:
        metrics = layer_metrics(cell, run, out)
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": all(c.ok for c in out.checks) and not out.failed,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": device_info(dev, cell.chips, out.memory_peak_bytes)}
    if trace and run.tracer.trace is not None:
        result["device"]["busy_s"] = run.tracer.trace.busy_s
        result["device"]["window_s"] = run.tracer.trace.window_s
        result["breakdown"] = run.tracer.trace.breakdown()
    if notes:
        result["notes"] = run.notes
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result


def layer_metrics(cell: manifest.Cell, run: Run, out: Outcome) -> dict:
    """Each per-layer metric of the cell from its own reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    if run.tracer.trace is None and run.device.type == "cuda":
        raise RuntimeError("--trace 1 ran no traced slice")
    ctx = dict(out.layer_ctx, trace=run.tracer.trace, config=run.cfg,
               traffic=run.traffic)
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    got = {}
    for name, reader in cell.layer_readers().items():
        v = reader.read(ctx)
        if v is not None:
            got[name] = {"value": v, "unit": units[name]}
    return got


def device_info(dev, chips: int, peak: int) -> dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"

