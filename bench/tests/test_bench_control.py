"""The control: the reference put in the program's place one precision step
below the configuration's bf16 (every matrix product in fp8 E4M3) must
come out not correct, and the program correct, on three seeds, at the
cell's own size and load with a window of a few syncs.  Card only (about
3 minutes for the two cells):

    PYTHONPATH=src python -m pytest -m requires_cuda bench/tests/test_bench_control.py

On the CPU the control path itself runs at smoke size."""
import pytest
import torch

import smoke
from harness import manifest, runner

CELLS = {"granite8b.long_decode": 3, "dsmoe16b.batch_decode": 3}
SEEDS = (2 ** 35 + 101, 2 ** 35 + 202, 2 ** 35 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")


def _compared(cell):
    limits = manifest.Cell(manifest.load_manifest(), cell).limits
    return dict(limits)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_and_program_passes(cell, card):
    limits = _compared(cell)
    for seed in SEEDS:
        res = runner.run_cell(cell, seed, CELLS[cell], False, control=True,
                              notes=True)
        assert res["correct"], res["checks"]
        low = res["notes"]["control"]
        assert any(low[k] > v for k, v in limits.items()), (seed, low)
        runner.free_device_memory()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_path_runs_at_smoke_size(cell):
    res = runner.run_cell(cell, 5, 1.0, False, device="cpu",
                          overrides=smoke.overrides(cell), control=True,
                          notes=True)
    low, got = res["notes"]["control"], res["notes"]["program"]
    assert set(low) == set(got) >= set(_compared(cell))
    assert all(v >= 0 for v in low.values())
