"""Shared setup of the port's degradation parity tests
(``test_torch_degradation.py`` and ``test_torch_degradation_faults.py``,
one suite split in two so that ``--dist loadfile`` runs the halves on two
workers): the tiny config and policy, the converted params, the
reference Engine with its one deviation flagged (``_JEngine``), and the
helpers that drive both engines and compare their summaries."""
import re
import time as real_time
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import repro.core.block_pool as jbp
import repro.serving as jsv
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.config import ArchConfig as JArch
from repro.models import transformer as JT
from repro.serving import loadgen as jload

import repro_torch.core.block_pool as tbp
import repro_torch.serving as tsv
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.config import ArchConfig
from repro_torch.serving import loadgen as tload


SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
# packed region: max_len 44 - (window 8 + sink 4) = 32 tokens = 4 x 8
MAX_LEN, BT = 44, 8
COUNTERS = ("preemptions", "spilled_blocks", "restored_blocks",
            "deadline_misses", "cancelled", "shed", "nan_quarantines",
            "watchdog_trips", "pool_exhausted_stalls")
BACKENDS = ["reference", "pallas"]


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


class _JEngine(jsv.Engine):
    """The reference Engine with its activated chunked job's table row
    flushed (the deviation of the module docstring)."""

    def _finish_prefill(self, job, logits):
        super()._finish_prefill(job, logits)
        for pool in self._pools.values():
            pool.dirty = True


def _sides(params, backend="reference"):
    """The two engines' factories and their modules, side by side."""
    jp, tp = params

    def jmk(**kw):
        return _JEngine(jp, JCFG, JPolicy(**KW), backend=backend,
                        **_defaults(kw))

    def tmk(**kw):
        return tsv.Engine(tp, TCFG, QuantPolicy(**KW), backend="cuda",
                          device="cpu", **_defaults(kw))
    return (SimpleNamespace(name="jax", mk=jmk, sv=jsv),
            SimpleNamespace(name="port", mk=tmk, sv=tsv))


def _defaults(kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("steps_per_sync", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("pool_blocks", 24)
    kw.setdefault("pool_block_tokens", BT)
    return kw


def _prompt(seed, n):
    return np.asarray(np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], (n,)), np.int32)


def _drive(eng, cap=800):
    n = 0
    while eng.step():
        n += 1
        assert n < cap, "engine still busy — hung stream / deadlock"
    eng.drain()


def _summary(eng, handles):
    """What must agree between the engines, after the audit passed."""
    audit = eng.check_invariants()
    st = eng.stats()
    c = st["counters"]
    for h in handles:
        assert h.finished and tsv.FinishReason.valid(h.finish_reason)
    return {"streams": [list(h.tokens) for h in handles],
            "reasons": [h.finish_reason for h in handles],
            "preempted": [h.preempted for h in handles],
            "events": [list(h.events) for h in handles],
            "counters": {k: c[k] for k in COUNTERS},
            "host_spill": st.get("host_spill"),
            "audit": audit}


def _both(params, scenario, backend="reference"):
    """Run ``scenario(side)`` on both engines; assert equal summaries."""
    want, got = (scenario(side) for side in _sides(params, backend))
    assert got == want
    return got
