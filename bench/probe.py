#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process, with the
control beside them: what a limit of ``bench/limits/<workload>.json`` is
set from (the program's largest reading, the control's smallest).

    python3 bench/probe.py --workload <name> --seeds 11,12,13 \\
        --seconds <s> [--control]

Each seed is a whole run (weights, inputs, window, reference) at the
cell's own size and load; ``--seconds`` only has to be long enough to
serve the ``check_tokens`` that the comparison reads.  One JSON line a
seed: the checks, the control's reading and the end-to-end metrics.  The
benchmark's own runs never run the control."""
from __future__ import annotations

import argparse
import json
import sys
import time

from harness import runner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    print(f"card: {runner.power_limit()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = runner.run_cell(args.workload, seed, args.seconds, False,
                              control=args.control, notes=True)
        row = {"seed": seed, "correct": res["correct"],
               "failed": res["failed"], "checks": res["checks"],
               "control": res["notes"].get("control"),
               "program": res["notes"].get("program"),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        runner.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
