#!/usr/bin/env python3
"""Time the port's bulk kv_quant kernel of two source trees on one card, in
turns: parent, change, change, parent.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/kv_quant_ab.py --parent build/parent      # needs a card

Each turn is a process of its own that imports ``repro_torch`` from one
tree, compiles only that tree's ``csrc/kv_quant.cu`` (into the tree's own
``build/``), and launches ``kv_quant`` on the same seeded inputs: one
layer of a 3000-token llama2-7b prefill (91,744 = 2867 x 32 rows of 128
bf16 channels), K 2-bit and V 1.5-bit, per-row
(N, G) clip factors (the form both trees take; the change also takes
per-head (H, G) factors and is timed with them too).  It checks 0
differing bytes against that tree's plain version and times the kernel
L2-cold (launches queued behind a sleep kernel, rotating over 4 copies of
the input).  Prints one JSON line per turn, then a summary line.  Imports
neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = 2867 * 32                 # one layer of a 3000-token llama2-7b prefill
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
COPIES = 4
HOLD_CYCLES = 20_000_000


def _cuda_ms(fns, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(src: str, rows: int) -> dict:
    """One turn: the kernel of the tree at ``src`` at ``rows`` rows."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _build
    _build.SOURCES = ("kv_quant",)          # this measurement needs one
    from repro_torch.core.quant import n_meta_groups
    from repro_torch.kernels import kv_quant as KQ
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    cases = []
    for bits in (2.0, 1.5):
        heads = 0.8 + 0.2 * torch.rand((32, n_meta_groups(128, bits, 128)),
                                       generator=gen, device=dev)
        forms = {"per_row": heads.repeat(rows // 32, 1)}
        if "append" in KQ.LAUNCHES:             # takes (H, G) directly
            forms["per_head"] = heads
        for form, alpha in forms.items():
            got = KQ.kv_quant(x, bits, 128, alpha)
            want = KQ.kv_quant_plain(x, bits, 128, alpha)
            diff = sum(int((got[k].view(torch.uint8)
                            != want[k].view(torch.uint8)).sum())
                       for k in want)
            ms = _cuda_ms([lambda c=c: KQ.kv_quant(c, bits, 128, alpha)
                           for c in xs])
            nbytes = (x.numel() * 2 + alpha.numel() * 4
                      + sum(v.numel() * v.element_size()
                            for v in got.values()))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cases.append({"bits": bits, "alpha": form, "diff_bytes": diff,
                          "ms": ms, "bytes": nbytes, "bound_ms": bound_ms,
                          "bound_share": bound_ms / ms})
            del got, want
    return {"src": src, "rows": rows, "cases": cases,
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a tree holding the parent's "
                    "src/repro_torch")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, ROWS)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    turns = []
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, __file__, "--child",
                               trees[name]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
            return 1
        res = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   tree=name)
        print(json.dumps(res), flush=True)
        turns.append(res)
    summary = {}
    for t in turns:
        for c in t["cases"]:
            key = f"{t['tree']} bits={c['bits']} {c['alpha']}"
            summary.setdefault(key, []).append(c["ms"])
    bad = [c for t in turns for c in t["cases"] if c["diff_bytes"]]
    print(json.dumps({"gpu": gpu, "rows": ROWS, "order":
                      "parent change change parent", "ms": summary,
                      "all_bytes_equal": not bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
