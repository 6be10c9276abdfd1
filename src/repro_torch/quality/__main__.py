"""The quality studies: one per paper table/figure, on the card by default.

    PYTHONPATH=src python -m repro_torch.quality [--only table1,fig5,...]
        [--smoke] [--device cpu] [--cache-dir DIR] [--json PATH]

Prints ``name,derived`` rows (plus a header), the reference harness's rows
without its timing column; a study that fails prints ``<study>_FAILED`` and
makes the run exit 1 after the others.  The trained models are cached under
``--cache-dir`` (default ``experiments/``): ``bench_model_torch`` and
``schedule_model_torch_<steps>``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

from ..device import resolve_device
from . import (common, component_ablation, group_window, needle_proxy,
               quality_ladder, schedule_quality)

SUITES = {
    "table1": quality_ladder.run,        # + Table 5 + schedule sweep
    "table3": component_ablation.run,
    "table4": group_window.run,          # + Fig 4, Fig 6, Table 2
    "fig5": needle_proxy.run,            # + Fig 7
    "schedule": schedule_quality.run,    # mixed-schedule quality per byte
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(SUITES))
    ap.add_argument("--smoke", action="store_true",
                    help="the fast subset (schedule only, unless --only); "
                         "studies honoring it get smoke=True")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cache-dir", default=None,
                    help="where the trained models are cached "
                         "(default experiments/)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the rows as JSON")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))
    if args.only:
        pick = set(args.only.split(","))
        unknown = pick - set(SUITES)
        if unknown:
            ap.error(f"unknown studies {sorted(unknown)}; "
                     f"choose from {','.join(SUITES)}")
    elif args.smoke:
        pick = {"schedule"}
    else:
        pick = set(SUITES)
    root = args.cache_dir or str(common.EXPERIMENTS)
    print("name,derived")
    rows = []

    def emit(r: str):
        print(r, flush=True)
        name, _, derived = r.partition(",")
        rows.append({"name": name, "derived": derived})

    t0 = time.time()
    failures = []
    for name, fn in SUITES.items():
        if name not in pick:
            continue
        kw = {"device": dev,
              "cache_dir": os.path.join(root, "schedule_model_torch"
                                        if name == "schedule"
                                        else "bench_model_torch")}
        if "smoke" in inspect.signature(fn).parameters:
            kw["smoke"] = args.smoke
        try:
            fn(emit, **kw)
        except Exception as e:  # keep going; report at the end
            failures.append((name, repr(e)))
            emit(f"{name}_FAILED,{type(e).__name__}")
    print(f"# total {time.time() - t0:.1f}s on {dev}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "device": dev, "rows": rows,
                       "failures": [{"suite": n, "error": e}
                                    for n, e in failures]}, f, indent=2)
    for name, err in failures:
        print(f"# FAILED {name}: {err}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
