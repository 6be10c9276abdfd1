"""Whole runs of each cell on the CPU at smoke size, past the harness's
look for a card: sound, ``correct`` comes out true; with the timed path
broken underneath, false, once for each fault a serving cell can have:

* the step returns its state unchanged (the caches roll back after it);
* half of the batch left out, the rest's mean logits in its place;
* a token altered where it is produced, in every slot or in the last
  slot alone (the comparison reads every slot).

(The exchange between chips has no fault here: every cell is one chip.)
The runs are in f32 (the configuration's ``dtype`` overridden), where the
port computes the reference's function to f32 rounding, so a smoke limit
(:data:`LIMIT`) far below any fault's reading holds every sound run; the
cells' own limits come from bf16 runs at full size on the card
(PERF.md)."""
import pytest
import torch

import smoke
from harness import inputs, manifest, runner

LIMIT = 1e-3
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _run(cell, monkeypatch, fault=None, seed=2 ** 35 + 7):
    limits = {"max_logit_gap": LIMIT}
    real = manifest.Cell.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        self.limits = limits
    monkeypatch.setattr(manifest.Cell, "__init__", init)
    over = smoke.overrides(cell)
    over["config"] = dict(over["config"], dtype="float32")
    return runner.run_cell(cell, seed, 1.5, False, device="cpu",
                           overrides=over, fault=fault)


def _rollback(step, caches):
    leaves = inputs.tree_leaves(caches)

    def bad(*args):
        keep = [t.clone() for t in leaves]
        out = step(*args)
        for t, k in zip(leaves, keep):
            t.copy_(k)
        return out
    return bad


def _alter(step, caches):
    def bad(*args):
        nxt, *rest = step(*args)
        return ((nxt + 101) % 256, *rest)
    return bad


def _alter_last(step, caches):
    def bad(*args):
        nxt, *rest = step(*args)
        nxt = nxt.clone()
        nxt[-1] = (nxt[-1] + 101) % 256
        return (nxt, *rest)
    return bad


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.decode_step

    def bad(*args, **kw):
        logits, caches = orig(*args, **kw)
        h = (logits.shape[0] + 1) // 2        # slot 0 is always in use
        logits = logits.clone()
        logits[:h] = logits[h:].mean(dim=0, keepdim=True)
        return logits, caches
    monkeypatch.setattr(T, "decode_step", bad)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    res = _run(cell, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["rollback", "half_batch", "alter",
                                   "alter_last"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant = None
    if fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        plant = {"rollback": _rollback, "alter": _alter,
                 "alter_last": _alter_last}[fault]
    res = _run(cell, monkeypatch, fault=plant)
    assert not res["correct"], res["checks"]
