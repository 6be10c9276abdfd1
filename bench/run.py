#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``), on a machine with the cards the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiled slice, with the device's busy time
and a breakdown.  The last line of standard output is one JSON object;
the numbers compared for ``correct`` close standard error and the line.
Without the cards, without the port, or with the JAX stack loaded once
the window has closed, it prints no result and exits non-zero."""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from harness import manifest, runner

T0 = time.perf_counter() - runner.process_age()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = manifest.Cell(manifest.load_manifest(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cannot resolve the cell: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t0=T0)
    except Exception:  # noqa: BLE001 -- report any failure, print no result
        traceback.print_exc()
        return 1
    # read after the run: nvidia-smi's time would fall in the set-up
    print(f"card: {runner.power_limit()}", file=sys.stderr, flush=True)
    found = runner.loaded_guarded()
    if found:
        print(f"the JAX stack or package is loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
