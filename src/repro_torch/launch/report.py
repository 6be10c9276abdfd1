"""Roofline tables from a dry-run's rows (port of ``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun.json

Prints the single-pod (16x16) baseline table of every cell, the
multi-pod (2x16x16) trace check and the variant tables, as the reference
does.  "fits?" tests a cell's ``temp + argument`` against the H100's
80 GiB (``roofline.DEVICE_MEMORY_GIB``) where the reference tests the
TPU v5e's 16.
"""
from __future__ import annotations

import json
import sys

from ..configs import shapes as shp
from .roofline import DEVICE_MEMORY_GIB


def fmt_t(x):
    return f"{x:.3e}"


def load(path="experiments/dryrun.json"):
    with open(path) as f:
        return json.load(f)


def baseline_table(rows, mesh="16x16"):
    out = ["| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) "
           "| dominant | MODEL/HLO flops | roofline frac | temp GiB | fits? |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    sel = [r for r in rows if r.get("variant", "base") == "base"
           and r["mesh"] == mesh]
    sel.sort(key=lambda r: (r["arch"], list(shp.SHAPES).index(r["shape"])))
    for r in sel:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped | "
                       f"— | — | — | ({r['reason'][:48]}) |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR {r['error'][:40]} |")
            continue
        x, m = r["roofline"], r["memory"]
        temp = m["temp"] / 2 ** 30
        fits = ("yes" if temp + m["argument"] / 2 ** 30 < DEVICE_MEMORY_GIB
                else "**no**")
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_t(x['t_compute'])} | "
            f"{fmt_t(x['t_memory'])} | {fmt_t(x['t_collective'])} | "
            f"{x['dominant']} | {x['useful_ratio']:.2f} | "
            f"{x['roofline_fraction']:.4f} | {temp:.1f} | {fits} |")
    return "\n".join(out)


def variant_rows(rows, arch, shape, mesh="16x16"):
    sel = [r for r in rows if r["arch"] == arch and r["shape"] == shape
           and r["mesh"] == mesh and r["status"] == "ok"]
    order = {"base": 0}
    sel.sort(key=lambda r: order.get(r.get("variant", "base"), 1))
    out = [f"**{arch} × {shape} ({mesh})**", "",
           "| variant | t_compute | t_memory | t_collective | dominant | temp GiB |",
           "|---|---|---|---|---|---|"]
    for r in sel:
        x, m = r["roofline"], r["memory"]
        out.append(f"| {r.get('variant', 'base')} | {fmt_t(x['t_compute'])} | "
                   f"{fmt_t(x['t_memory'])} | {fmt_t(x['t_collective'])} | "
                   f"{x['dominant']} | {m['temp']/2**30:.1f} |")
    return "\n".join(out)


def multipod_check(rows):
    ok = sum(1 for r in rows if r["mesh"] == "2x16x16"
             and r.get("variant", "base") == "base" and r["status"] == "ok")
    skip = sum(1 for r in rows if r["mesh"] == "2x16x16"
               and r.get("variant", "base") == "base"
               and r["status"] == "skipped")
    err = sum(1 for r in rows if r["mesh"] == "2x16x16"
              and r.get("variant", "base") == "base" and r["status"] == "error")
    return ok, skip, err


def main():
    rows = load(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun.json")
    print("## Single-pod (16×16) baseline roofline, all cells\n")
    print(baseline_table(rows, "16x16"))
    print("\n## Multi-pod (2×16×16) compile check\n")
    ok, skip, err = multipod_check(rows)
    print(f"{ok} ok / {skip} skipped / {err} errors")
    print("\n## Variants\n")
    for arch, shape in (("deepseek_moe_16b", "train_4k"),
                        ("gemma2_27b", "train_4k"),
                        ("gemma2_27b", "decode_32k"),
                        ("gemma3_4b", "long_500k"),
                        ("hymba_1p5b", "long_500k"),
                        ("llama3p2_1b", "train_4k"),
                        ("granite_moe_1b_a400m", "train_4k")):
        print(variant_rows(rows, arch, shape))
        print()


if __name__ == "__main__":
    main()
