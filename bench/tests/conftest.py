"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the repository.  They import the harness from ``bench/`` and the
port from ``src/``; tests that need a card skip here."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
