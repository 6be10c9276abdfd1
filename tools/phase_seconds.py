#!/usr/bin/env python3
"""Seconds that some of ``chip_smoke.py``'s phases take in one source tree
on one card: how a cut of the card script is shown to save time.

    git archive <parent> | tar -x -C build/parent
    python3 tools/phase_seconds.py build/parent parent serve serve_graph
    python3 tools/phase_seconds.py . change serve serve_graph

Imports ``chip_smoke`` and ``repro_torch`` from the tree given, runs its
``phase_env`` and ``phase_build``, then the phases named, in order, on
one shared state (a phase that reads what another leaves needs that one
named before it; the launch totals, which serve and serve_pooled start,
start at 0 here).  Prints one JSON line a phase, then one with
the seconds of each and their total; exits non-zero if a phase fails.
Setting ``REPRO_TORCH_BUILD_DIR`` to one directory for both runs shares
the kernels' build between two trees whose sources are the same.
Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree, label, names = os.path.abspath(argv[0]), argv[1], argv[2:]
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke as CS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, seconds = {"launches": {}}, {}
    for name in ("env", "build", *names):
        t0 = time.monotonic()
        getattr(CS, f"phase_{name}")(state)
        for k in ("decode_attn", "decode_attn_pooled", "kv_quant",
                  "kv_append"):
            state["launches"].setdefault(k, 0)
        seconds[name] = round(time.monotonic() - t0, 1)
        print(json.dumps({"tree": label, "phase_s": name,
                          "s": seconds[name]}), flush=True)
    print(json.dumps({"tree": label, "seconds": seconds,
                      "total": round(sum(seconds.values()), 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
