"""Find a cell's pieces by the names in ``BENCHMARK.json``.

Every configuration, traffic mix, driver, per-layer metric, reference
family and correctness limit is a file of its own, found by name:

* ``bench/configs/<config>.json`` (the entry's ``file``)
* ``bench/traffic/<traffic>.json``, whose ``driver`` names
  ``bench/drivers/<driver>.py``
* ``bench/layer_metrics/<metric>.py``, one reader per per-layer metric
* ``bench/reference/<family>.py``, the family the configuration names
* ``bench/limits/<workload>.json``, the limits of the cell's comparison

so a new cell, mix or metric is new files and a new entry, never an
edit of a file that is there."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (file names may hold
    dots, which ``import`` cannot spell)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with every file it needs resolved."""

    def __init__(self, manifest: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.root = root
        self.bench = root / "bench"
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_json(self.traffic_path(self.traffic_name))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if _reports(m, workload)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if _reports(m, workload)]
        self.limits = load_json(self.bench / "limits" / f"{workload}.json")

    def traffic_path(self, name: str) -> Path:
        return self.bench / "traffic" / f"{name}.json"

    def driver(self):
        kind = self.traffic["driver"]
        return load_module(self.bench / "drivers" / f"{kind}.py",
                           f"bench_driver_{kind}")

    def reference(self):
        fam = self.config["family"]
        return load_module(self.bench / "reference" / f"{fam}.py",
                           f"bench_reference_{fam}")

    def layer_readers(self) -> Dict[str, object]:
        return {m["name"]: load_module(
            self.bench / "layer_metrics" / f"{m['name']}.py",
            "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}


def _reports(metric: dict, workload: str) -> bool:
    """A metric without ``workloads`` is reported by every cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def metric_names(manifest: dict) -> List[str]:
    return [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
