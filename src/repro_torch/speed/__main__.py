"""The speed suites, on the card by default.

    PYTHONPATH=src python -m repro_torch.speed [--only table6,kernel,...]
        [--smoke] [--device cpu] [--json PATH]

Prints the card line (name and power limit; ``cpu`` off the card), then
the reference harness's ``name,us_per_call,derived`` rows (plus a header);
a suite that fails prints ``<suite>_FAILED`` and makes the run exit 1
after the others.  The quality studies are ``python -m
repro_torch.quality``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from ..device import resolve_device
from . import common as C
from . import kernel_bench, memory_latency, serving_bench

SUITES = {
    "table6": memory_latency.run,        # + App. 9, measured on the card
    "kernel": kernel_bench.run,
    "serve": serving_bench.run,          # TTFT + prefill shapes + open loop
    "chaos": serving_bench.run_chaos,    # seeded fault injection
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(SUITES))
    ap.add_argument("--smoke", action="store_true",
                    help="the fast subset: every suite, smoke=True")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the rows as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pick = set(args.only.split(",")) if args.only else set(SUITES)
    unknown = pick - set(SUITES)
    if unknown:
        ap.error(f"unknown suites {sorted(unknown)}; "
                 f"choose from {','.join(SUITES)}")
    card = C.gpu_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    print(C.HEADER, flush=True)
    rows = []

    def emit(row: str):
        print(row, flush=True)
        parts = row.split(",", 2)
        try:
            us = float(parts[1]) if len(parts) > 1 else 0.0
        except ValueError:
            us = 0.0
        rows.append({"name": parts[0], "us_per_call": us,
                     "derived": parts[2] if len(parts) > 2 else ""})

    t0 = time.time()
    failures = []
    for name, fn in SUITES.items():
        if name not in pick:
            continue
        kw = {"device": str(dev)}
        if "smoke" in inspect.signature(fn).parameters:
            kw["smoke"] = args.smoke
        try:
            fn(emit, **kw)
        except Exception as e:  # keep going; report at the end
            failures.append((name, repr(e)))
            emit(f"{name}_FAILED,0.0,{type(e).__name__}")
    print(f"# total {time.time() - t0:.1f}s on {dev}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "device": str(dev), "card": card,
                       "total_s": time.time() - t0, "rows": rows,
                       "failures": [{"suite": n, "error": e}
                                    for n, e in failures]}, f, indent=2)
    for name, err in failures:
        print(f"# FAILED {name}: {err}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
