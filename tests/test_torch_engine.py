"""Port serving engine vs the JAX ``Engine``: greedy token streams must be
EQUAL — ragged two-wave traffic with slot reuse, each request equal to its
own batch-of-1 run, and the ``ServeSession`` lock-step shim.  The JAX side
runs its ``"reference"`` backend; the port runs both its ``"reference"``
and its ``"cuda"`` backend (plain kernel versions on the CPU), which all
dequantize in f32 here.  Temperature > 0 cannot match ``jax.random``, so
sampled streams are checked for per-seed determinism only.
"""
import numpy as np
import pytest

import jax

from repro.core.policy import QuantPolicy as JPolicy
from repro.models.config import ArchConfig as JArch
from repro.models import transformer as JT
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import ServeSession as JSession

from repro_torch.core.policy import QuantPolicy
from repro_torch.convert import params_from_numpy
from repro_torch.models.config import ArchConfig
from repro_torch.serving import Engine, Request, ServeSession

SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _traffic():
    r = np.random.default_rng(7)
    lens, news = [12, 20, 12, 7, 30], [9, 4, 13, 6, 5]
    return [(r.integers(0, 64, n).astype(np.int32), m)
            for n, m in zip(lens, news)]


def _run_jax(jp, traffic, slots, sps=4):
    eng = JEngine(jp, JCFG, JPolicy(**KW), batch_slots=slots, max_len=48,
                  backend="reference", steps_per_sync=sps)
    hs = [eng.submit(JRequest(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    return [h.tokens for h in hs], [h.finish_reason for h in hs]


def _run_port(tp, traffic, slots, backend, sps=4, temperature=0.0, seed=0):
    eng = Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=slots, max_len=48,
                 backend=backend, steps_per_sync=sps, seed=seed,
                 device="cpu")
    hs = [eng.submit(Request(prompt=p, max_new=m, seed=i,
                             temperature=temperature))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert eng.active_slots == 0 and eng.queue_depth == 0
    return [h.tokens for h in hs], [h.finish_reason for h in hs]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_ragged_two_wave_streams_equal_jax(params, backend):
    jp, tp = params
    traffic = _traffic()
    want, wr = _run_jax(jp, traffic, slots=2)
    got, gr = _run_port(tp, traffic, slots=2, backend=backend)
    assert got == want
    assert gr == wr == ["length"] * len(traffic)


def test_each_request_equals_its_batch_of_one_run(params):
    _, tp = params
    traffic = _traffic()
    batched, _ = _run_port(tp, traffic, slots=3, backend="cuda", sps=3)
    for i, item in enumerate(traffic):
        alone, _ = _run_port(tp, [item], slots=1, backend="cuda", sps=5)
        assert alone[0] == batched[i], i


def test_eos_finishes_and_frees_the_slot(params):
    jp, tp = params
    traffic = _traffic()
    want, _ = _run_jax(jp, traffic, slots=2)
    eos = want[0][3]                   # a token request 0 emits mid-stream
    eng = Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=2, max_len=48,
                 steps_per_sync=4, device="cpu")
    hs = [eng.submit(Request(prompt=p, max_new=m, eos_id=eos))
          for p, m in traffic]
    eng.run(hs)
    assert hs[0].finish_reason == "eos"
    assert hs[0].tokens == want[0][:want[0].index(eos) + 1]
    assert all(h.finished for h in hs)


def test_serve_session_lockstep_equals_jax(params):
    jp, tp = params
    prompts = np.random.default_rng(3).integers(0, 64, (2, 15)).astype(
        np.int32)
    want = JSession(jp, JCFG, JPolicy(**KW), batch_slots=2, max_len=40,
                    backend="reference", steps_per_sync=4).generate(
                        prompts, max_new=11)
    got = ServeSession(tp, TCFG, QuantPolicy(**KW), batch_slots=2,
                       max_len=40, backend="cuda", steps_per_sync=4,
                       device="cpu").generate(prompts, max_new=11)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_is_deterministic_per_seed(params):
    _, tp = params
    traffic = _traffic()[:3]
    a, _ = _run_port(tp, traffic, 2, "cuda", temperature=0.8, seed=5)
    b, _ = _run_port(tp, traffic, 2, "cuda", temperature=0.8, seed=5)
    c, _ = _run_port(tp, traffic, 2, "cuda", temperature=0.8, seed=6)
    greedy, _ = _run_port(tp, traffic, 2, "cuda")
    assert a == b
    assert a != c and a != greedy
    assert all(0 <= t < 64 for s in a for t in s)


def test_submit_validates_requests(params):
    _, tp = params
    eng = Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=1, max_len=16,
                 device="cpu")
    for bad in (Request(prompt=[]), Request(prompt=[1, 2], max_new=0),
                Request(prompt=[1] * 10, max_new=7),
                Request(prompt=[64], max_new=1)):
        with pytest.raises(ValueError):
            eng.submit(bad)
