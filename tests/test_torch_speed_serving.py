"""The port's decode-backend rows (``repro_torch.speed.kernel_bench``)
and serving suites (``repro_torch.speed.serving_bench``) against the
reference harness (``benchmarks/kernel_bench.py``,
``benchmarks/serving_bench.py``) on the CPU, on weights carried across
from the JAX package.

The reference's ``_open_loop_suite`` and its JAX compile counter are not
called (jax 0.9.0 breaks the counter); the port's open-loop, overload and
chaos suites are held to their own gates at the smoke size, under a tick
clock.

Tolerances, and why:

* prefill shapes, occupancies, host syncs, pool stats, token streams:
  EXACT (integers; greedy tokens on equal weights);
* reference-backend logits against JAX's: ``atol = rtol = 2e-4``
  (tests/test_torch_model.py's: the same f32 math, summed in another
  order);
* the backend drift: the suite's own gate, 2e-2.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import serving_bench as JS                 # noqa: E402
from repro import configs as jconfigs                      # noqa: E402
from repro.core.policy import QuantPolicy as JPolicy       # noqa: E402
from repro.data import SyntheticCorpus as JCorpus          # noqa: E402
from repro.models import transformer as JT                 # noqa: E402
from repro.serving import Engine as JEngine                # noqa: E402
from repro.serving import Request as JRequest              # noqa: E402
from repro.serving import ServeSession as JSession         # noqa: E402

from repro_torch import configs                            # noqa: E402
from repro_torch.convert import params_from_numpy          # noqa: E402
from repro_torch.serving import Engine, TickClock          # noqa: E402
from repro_torch.speed import kernel_bench as KB           # noqa: E402
from repro_torch.speed import serving_bench as SB          # noqa: E402
from test_torch_util import t2n                            # noqa: E402
from test_torch_util import (  # noqa: F401,E402
    jax_compile_cache, one_torch_thread)

CPU = "cpu"
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def model():
    """The smoke llama3.2-1b: JAX params from key 0 and the port's copy."""
    jcfg = jconfigs.get_smoke("llama3p2_1b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke("llama3p2_1b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return jcfg, jp, cfg, tp


def _rows(fn, *args, **kw):
    out = []
    res = fn(out.append, *args, **kw)
    return out, res


def _names(rows):
    return [r.split(",", 1)[0] for r in rows]


# ------------------------------------------------------- decode backends

def test_decode_step_backends_against_the_reference(model):
    """``decode_step`` through every backend (drift within the gate), the
    reference backend's logits against JAX's, and the ServeSession sync
    rows: measured host syncs, streams equal to the reference
    ServeSession's."""
    jcfg, jp, cfg, tp = model
    rows, got = _rows(KB._bench_decode_step_backends, True, CPU, tp)
    assert got["drift"] <= KB.DRIFT_GATE
    assert _names(rows) == ["decode_step_backend_cuda",
                            "decode_step_backend_reference",
                            "decode_step_backend_drift",
                            "engine_generate_sync1", "engine_generate_sync8"]
    rng = np.random.default_rng(1)
    pol = JPolicy(bits_k=2.0, bits_v=1.5, group_size=min(64, jcfg.head_dim),
                  window=16, n_sink=4)
    s = 32
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, s)), jnp.int32)
    _, caches = JT.prefill_model(jp, jcfg, {"tokens": toks}, pol,
                                 max_len=s + 32)
    nxt = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 1)), jnp.int32)
    want, _ = JT.decode_step(jp, jcfg, nxt, caches, pol)
    np.testing.assert_allclose(t2n(got["logits"]["reference"]),
                               np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert got["host_syncs"] == {1: 7, 8: 1}
    prompts = np.asarray(rng.integers(0, jcfg.vocab_size, (2, s)), np.int32)
    for n_sync in (1, 8):
        sess = JSession(jp, jcfg, pol, batch_slots=2, max_len=s + 32,
                        steps_per_sync=n_sync)
        np.testing.assert_array_equal(got["streams"][n_sync],
                                      sess.generate(prompts, max_new=8))


# ----------------------------------------------------------- serving suite

class _Recorded(JEngine):
    """The reference Engine, keeping the handles it was given."""
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.handles = []
        _Recorded.made.append(self)

    def submit(self, request):
        h = super().submit(request)
        self.handles.append(h)
        return h


def _jax_requests(jcfg, smoke=True):
    corpus = JCorpus(jcfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    lens = [24, 41, 57, 33, 62, 49]
    return [JRequest(prompt=corpus.sample(n, np.random.default_rng(i)),
                     max_new=int(rng.integers(4, 9)), seed=i)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("chunk", [None, 16])
def test_serve_equals_the_reference(model, monkeypatch, chunk):
    """The ragged closed loop, whole-prompt and chunked: streams, prefill
    shapes and occupancies equal the reference helper's."""
    jcfg, jp, cfg, tp = model
    reqs = SB.ragged_requests(cfg, True)
    jreqs = _jax_requests(jcfg)
    assert [list(r.prompt) for r in reqs] == [list(r.prompt) for r in jreqs]
    max_len = max(len(r.prompt) for r in reqs) + 16
    got = SB._serve(tp, cfg, SB._policy(cfg), reqs, max_len, chunk, CPU)
    monkeypatch.setattr(JS, "Engine", _Recorded)
    _Recorded.made.clear()
    jpol = JPolicy(bits_k=2.0, bits_v=1.5, group_size=min(16, jcfg.head_dim),
                   window=16, n_sink=4)
    want = JS._serve(jp, jcfg, jpol, jreqs, max_len, chunk)
    for key in ("prefill_shapes", "occ_mean", "occ_max"):
        assert got[key] == want[key], key
    assert got["streams"] == [h.result().tolist()
                              for h in _Recorded.made[0].handles]
    assert got["backend_info"]["max_len"] == max_len


def test_serve_pool_equals_the_reference(model):
    """The shared-prefix wave through the block pool: streams, admitted
    concurrency and the pool's counters equal the reference helper's."""
    jcfg, jp, cfg, tp = model
    corpus, jcorpus = (SB.SyntheticCorpus(cfg.vocab_size, seed=0),
                       JCorpus(jcfg.vocab_size, seed=0))
    prefix = corpus.sample(72, np.random.default_rng(100))
    assert list(prefix) == list(jcorpus.sample(72,
                                               np.random.default_rng(100)))
    rng = np.random.default_rng(7)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=6).astype(prefix.dtype)]) for _ in range(3)]
    reqs = [SB.Request(prompt=p, max_new=6, seed=i)
            for i, p in enumerate(prompts)]
    jreqs = [JRequest(prompt=p, max_new=6, seed=i)
             for i, p in enumerate(prompts)]
    jpol = JPolicy(bits_k=2.0, bits_v=1.5, group_size=min(16, jcfg.head_dim),
                   window=16, n_sink=4)
    got = SB._serve_pool(tp, cfg, SB._policy(cfg), reqs, 84, 32, 8, 3, CPU)
    want = JS._serve_pool(jp, jcfg, jpol, jreqs, 84, 32, 8, 3)
    assert got["streams"] == want["streams"]
    assert got["concurrency"] == want["concurrency"]
    for key in ("prefix_hits", "prefix_misses", "cow_copies", "peak_used",
                "peak_resident_bytes", "striped_worst_case_bytes",
                "pool_blocks", "pool_block_tokens", "used", "free"):
        assert got["stats"][key] == want["stats"][key], key


def test_shared_prefix_suite_passes_its_gates(model):
    _, _, cfg, tp = model
    rows, res = _rows(SB._shared_prefix_suite, tp, cfg, True, CPU)
    assert _names(rows) == ["serve_shared_prefix_pooled",
                            "serve_shared_prefix_striped",
                            "serve_pool_summary"]
    assert rows[-1].endswith("gate=pass")
    assert res["stats"]["prefix_hit_rate"] > 0


def test_open_loop_suite_passes_its_gates_under_a_tick_clock(model):
    _, _, cfg, tp = model
    rows, res = _rows(SB._open_loop_suite, tp, cfg, True, CPU,
                      TickClock(0.01))
    assert _names(rows) == ["serve_warmup", "serve_open_loop",
                            "serve_saturation"]
    assert all(res["gates"].values()), res["gates"]
    assert "post_warmup_misses=0" in rows[1] and rows[1].endswith(
        "gate=pass")
    assert res["summary"]["n_finished"] == 8
    assert [r["rate"] for r in res["saturation"]["table"]] == [4.0, 12.0][
        :len(res["saturation"]["table"])]


def test_open_loop_suite_fails_on_a_graph_miss(model, monkeypatch):
    """Traffic that found a graph missing after warmup fails the suite."""
    _, _, cfg, tp = model
    real = Engine.warmup_report

    def missed(self):
        return dict(real(self), post_warmup_misses=1)
    monkeypatch.setattr(Engine, "warmup_report", missed)
    with pytest.raises(RuntimeError, match="no_graph_miss"):
        SB._open_loop_suite(lambda r: None, tp, cfg, True, CPU,
                            TickClock(0.01))


def test_overload_suite_passes_its_gates(model):
    _, _, cfg, tp = model
    rows, res = _rows(SB._overload_suite, tp, cfg, True, CPU,
                      TickClock(0.01))
    assert _names(rows) == ["serve_overload"]
    assert all(res["gates"].values()), res["gates"]
    assert res["counters"]["preemptions"] + \
        res["counters"]["pool_exhausted_stalls"] > 0


def test_chaos_suite_passes_its_gates(model):
    _, _, cfg, tp = model
    rows, res = _rows(SB.run_chaos, True, CPU, tp)
    assert _names(rows) == ["serve_chaos_pool", "serve_chaos_nan"]
    for name, r in res.items():
        assert all(r["gates"].values()), (name, r["gates"])
    assert res["nan"]["counters"]["nan_quarantines"] == 2
    assert res["nan"]["reasons"].get("shed") == 2
