"""The port's five quality studies (``repro_torch.quality``: Tables 1-5,
Figs 4-7 and the schedule study) and their CLI against the reference
harness (``benchmarks/quality_ladder.py``, ``component_ablation.py``,
``group_window.py``, ``needle_proxy.py``, ``schedule_quality.py``) on the
same models, on the CPU.

Neither side trains under ``experiments/``: each side's model function is
replaced in the test by the same stand-in, trained 60 steps by the
reference's ``train_or_restore`` into a temporary directory (the schedule
study's 4-layer model is JAX-initialised from key 3) and carried across.
Each reference study runs once, in a module fixture.

Tolerances, and why:

* row names, their order and every non-numeric field (``holds=``, the
  per-layer bits): EXACT.
* numbers: relative 1e-4 (``PPL_RTOL``, the evaluator's bound in
  tests/test_torch_quality.py: the f32 forwards differ in the last bits
  and a code on a rounding edge may flip), plus half a unit of the last
  printed decimal (a row prints 4 or 2 decimals, and a value within the
  tolerance can round the other way).
* top-1 agreement: EXACT; KL: relative 1e-3 with an absolute 1e-6 (a
  difference of two close log-probabilities).
* ``_staged(i)``: atol 1e-6 x max|x|, the bound of
  tests/test_torch_baselines.py for the fake-quant methods on equal
  inputs.
"""
import dataclasses
import json
import re
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

from benchmarks import common as JC                      # noqa: E402
from benchmarks import component_ablation as JA          # noqa: E402
from benchmarks import group_window as JG                # noqa: E402
from benchmarks import needle_proxy as JN                # noqa: E402
from benchmarks import quality_ladder as JL              # noqa: E402
from benchmarks import schedule_quality as JS            # noqa: E402
from repro import configs as jconfigs                    # noqa: E402
from repro.core.baselines import METHODS as J_METHODS    # noqa: E402
from repro.core.baselines import MethodCtx as JCtx       # noqa: E402
from repro.core.policy import QuantPolicy as JPolicy     # noqa: E402
from repro.data import SyntheticCorpus as JCorpus        # noqa: E402
from repro.models import transformer as JT               # noqa: E402

from repro_torch.convert import params_from_numpy        # noqa: E402
from repro_torch.core import baselines as TB             # noqa: E402
from repro_torch.core import calibrate as TC             # noqa: E402
from repro_torch.core.policy import QuantPolicy          # noqa: E402
from repro_torch.core.quant import quantize_groups       # noqa: E402
from repro_torch.data import SyntheticCorpus             # noqa: E402
from repro_torch.quality import __main__ as CLI          # noqa: E402
from repro_torch.quality import common as TQ             # noqa: E402
from repro_torch.quality import component_ablation as TA  # noqa: E402
from repro_torch.quality import group_window as TG       # noqa: E402
from repro_torch.quality import needle_proxy as TN       # noqa: E402
from repro_torch.quality import quality_ladder as TL     # noqa: E402
from repro_torch.quality import schedule_quality as TS   # noqa: E402
from test_torch_util import (  # noqa: F401,E402
    jax_compile_cache, one_torch_thread)

CPU = "cpu"
TRAIN = 60
PPL_RTOL = 1e-4
STUDIES = {"table1": (JL, TL), "table3": (JA, TA), "table4": (JG, TG),
           "fig5": (JN, TN), "schedule": (JS, TS)}


def _scaled(mod, **kw):
    return mod.get_smoke(JC.BENCH_ARCH).scaled(**kw)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX, port) model triples of the bench stand-in and of the 4-layer
    schedule model."""
    from repro_torch import configs
    bench = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=256)
    sched = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=128)
    jcfg = _scaled(jconfigs, **bench)
    jcorpus = JCorpus(jcfg.vocab_size, seed=11)
    jp = JC.train_or_restore(str(tmp_path_factory.mktemp("bench") / "m"),
                             jcfg, jcorpus, TRAIN)
    scfg = _scaled(jconfigs, **sched)
    sp = JT.init_params(scfg, jax.random.PRNGKey(3))
    out = {}
    for name, cfgs, p, seed in (("bench", (jcfg, _scaled(configs, **bench)),
                                 jp, 11),
                                ("sched", (scfg, _scaled(configs, **sched)),
                                 sp, 17)):
        out[name] = (
            (cfgs[0], p, JCorpus(cfgs[0].vocab_size, seed=seed)),
            (cfgs[1], params_from_numpy(jax.tree.map(np.asarray, p), cfgs[1],
                                        device=CPU),
             SyntheticCorpus(cfgs[1].vocab_size, seed=seed)))
    return out


def _use_models(monkeypatch, models):
    """Point both sides' model functions at the stand-ins."""
    jb, tb = models["bench"]
    js, ts = models["sched"]
    monkeypatch.setattr(JC, "bench_model", lambda: jb)
    monkeypatch.setattr(JS, "_sched_model", lambda steps: js)
    monkeypatch.setattr(TQ, "bench_model", lambda *a, **k: tb)
    monkeypatch.setattr(TS, "_sched_model", lambda *a, **k: ts)


@pytest.fixture(scope="module")
def reference_rows(models):
    """Each reference study run once: (rows as (name, derived), result)."""
    mp = pytest.MonkeyPatch()
    _use_models(mp, models)
    out = {}
    try:
        for name, (jmod, _) in STUDIES.items():
            rows = []
            res = jmod.run(rows.append)
            out[name] = ([(r.split(",", 2)[0], r.split(",", 2)[2])
                          for r in rows], res)
    finally:
        mp.undo()
    return out


_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def _same_derived(got: str, want: str, name: str):
    """Numbers within PPL_RTOL plus half a printed unit; the rest exact."""
    assert _NUM.sub("#", got) == _NUM.sub("#", want), (name, got, want)
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        dec = len(w.split(".")[1]) if "." in w else 0
        tol = PPL_RTOL * abs(float(w)) + 0.5 * 10 ** -dec
        assert abs(float(g) - float(w)) <= tol, (name, got, want)


def _assert_rows(got_rows, want_rows):
    assert [n for n, _ in got_rows] == [n for n, _ in want_rows]
    for (name, g), (_, w) in zip(got_rows, want_rows):
        _same_derived(g, w, name)


def _assert_result(got, want, what=""):
    if isinstance(want, dict):
        assert set(want) <= set(got), (what, sorted(want), sorted(got))
        for k in want:
            _assert_result(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        assert got == pytest.approx(float(want), rel=PPL_RTOL), what


def _run_port(name, monkeypatch, models):
    _use_models(monkeypatch, models)
    rows = []
    res = STUDIES[name][1].run(rows.append, device=CPU)
    return [tuple(r.split(",", 1)) for r in rows], res


@pytest.mark.parametrize("name", ["table3", "table4", "fig5", "schedule"])
def test_study_rows_equal_the_reference(name, models, reference_rows,
                                        monkeypatch):
    got_rows, got = _run_port(name, monkeypatch, models)
    want_rows, want = reference_rows[name]
    _assert_rows(got_rows, want_rows)
    _assert_result(got, want, name)


def test_cli_table1_equals_the_reference(models, reference_rows,
                                         monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.quality --only table1`` on the CPU: exit 0,
    a ``name,derived`` header, the reference's rows (no timing column),
    ``table1_sched_uniform_matches_skvq`` holding, the JSON artifact."""
    _use_models(monkeypatch, models)
    out = tmp_path / "rows.json"
    rc = CLI.main(["--only", "table1", "--smoke", "--device", "cpu",
                   "--cache-dir", str(tmp_path), "--json", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,derived"
    got_rows = [tuple(r.split(",", 1)) for r in lines[1:]]
    _assert_rows(got_rows, reference_rows["table1"][0])
    assert ("table1_sched_uniform_matches_skvq", "holds=True") in got_rows
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and not saved["failures"]
    assert [(r["name"], r["derived"]) for r in saved["rows"]] == got_rows


def test_table1_result_equals_the_reference(models, reference_rows,
                                            monkeypatch):
    _use_models(monkeypatch, models)
    got = TL.run(lambda r: None, device=CPU)
    _assert_result(got, reference_rows["table1"][1], "table1")
    assert abs(got["sched_uniform"] - got["skvq"]) < 1e-6


def test_cli_reports_a_failed_study_and_exits_1(monkeypatch, tmp_path,
                                                capsys):
    def boom(emit, **kw):
        raise RuntimeError("no model")
    monkeypatch.setitem(CLI.SUITES, "fig5", boom)
    rc = CLI.main(["--only", "fig5", "--device", "cpu",
                   "--cache-dir", str(tmp_path)])
    out = capsys.readouterr()
    assert rc == 1
    assert "fig5_FAILED,RuntimeError" in out.out
    assert "# FAILED fig5" in out.err


def test_cli_routes_each_study_to_its_cache_and_smoke(monkeypatch, tmp_path,
                                                      capsys):
    seen = {}
    for name in CLI.SUITES:
        def fake(emit, name=name, **kw):
            seen[name] = kw
        if name == "schedule":
            def fake(emit, smoke=False, name=name, **kw):  # noqa: F811
                seen[name] = dict(kw, smoke=smoke)
        monkeypatch.setitem(CLI.SUITES, name, fake)
    assert CLI.main(["--smoke", "--device", "cpu", "--cache-dir",
                     str(tmp_path)]) == 0
    assert seen == {"schedule": {"device": "cpu", "smoke": True,
                                 "cache_dir": str(tmp_path /
                                                  "schedule_model_torch")}}
    seen.clear()
    assert CLI.main(["--device", "cpu", "--cache-dir", str(tmp_path)]) == 0
    assert sorted(seen) == sorted(CLI.SUITES)
    assert seen["table4"]["cache_dir"] == str(tmp_path / "bench_model_torch")
    assert seen["schedule"]["smoke"] is False
    with pytest.raises(SystemExit):
        CLI.main(["--only", "table6", "--device", "cpu"])
    if not torch.cuda.is_available():       # the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CLI.main(["--only", "table1"])
    capsys.readouterr()


# --------------------------------------------------------------- _staged

@pytest.fixture(scope="module")
def kv_case():
    """Structured K/V (log-normal channel scales, two outliers) and the
    reference's calibration of them at the ablation's base policy."""
    from repro.core import calibrate as JCal
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 64, 2, 32
    scales = np.exp(rng.normal(size=(1, 1, h, d)))
    scales[..., :2] *= 20
    k = (rng.normal(size=(b, s, h, d)) * scales).astype(np.float32)
    v = (rng.normal(size=(b, s, h, d)) * np.roll(scales, 5, -1)
         ).astype(np.float32)
    kw = dict(bits_k=2.0, bits_v=2.0, group_size=16, window=32, n_sink=5,
              fp8_meta=False)
    cal = JCal.calibrate_layer(k.reshape(-1, h, d), v.reshape(-1, h, d),
                               JPolicy(**kw))
    return k, v, cal


@pytest.mark.parametrize("stage", range(len(JA.STAGES)))
def test_staged_equals_the_reference(stage, kv_case):
    k, v, cal = kv_case
    kw = dict(bits_k=2.0, bits_v=2.0, group_size=16, window=0, n_sink=0,
              fp8_meta=stage >= 5)
    jk, jv = JA._staged(stage)(jnp.asarray(k), jnp.asarray(v),
                               JCtx(JPolicy(**kw), cal))
    tcal = TC.LayerCalibration(**dataclasses.asdict(cal))
    calls = []

    def spy(*args):
        calls.append(args[1:3])
        return quantize_groups(*args)
    tk, tv = TA._staged(stage)(torch.from_numpy(k), torch.from_numpy(v),
                               TB.MethodCtx(QuantPolicy(**kw), tcal, spy))
    for got, want, x in ((tk, jk, k), (tv, jv, v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * np.abs(x).max())
    # the stage quantizes through the context's quantizer (the bulk kernel
    # on the card), never fake_quant's plain default
    assert calls == [(2.0, 16), (2.0, 16)]


def test_stages_add_up(kv_case):
    """Each rung changes the result: reorder and clip move the values,
    fp8 metadata rounds them again."""
    k, v, cal = kv_case
    tcal = TC.LayerCalibration(**dataclasses.asdict(cal))
    outs = []
    for stage in (0, 2, 3, 5):
        pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=16, window=0,
                          n_sink=0, fp8_meta=stage >= 5)
        outs.append(TA._staged(stage)(torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      TB.MethodCtx(pol, tcal))[0])
    for a, b in zip(outs, outs[1:]):
        assert not torch.equal(a, b)


# ---------------------------------------------------------------- _agree

@pytest.mark.parametrize("method", ["skvq", "rtn"])
@pytest.mark.parametrize("depth", [0.1, 0.9])
def test_agree_equals_the_reference(method, depth, models):
    from repro.data import make_passkey_sample as j_passkey
    from repro_torch.data import make_passkey_sample
    (jcfg, jp, jcorpus), (cfg, tp, corpus) = models["bench"]
    pos = int(depth * (TN.SEQ - 40)) + 8
    toks = np.stack([make_passkey_sample(corpus, TN.SEQ, pos,
                                         np.random.default_rng(i))[0]
                     for i in range(4)])
    jtoks = np.stack([j_passkey(jcorpus, JN.SEQ, pos,
                                np.random.default_rng(i))[0]
                      for i in range(4)])
    np.testing.assert_array_equal(toks, jtoks)
    kw = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=32, n_sink=5)
    if method == "rtn":
        kw.update(window=0, n_sink=0, clip=False, reorder=False)
    jcal = JC.calibrate(jcfg, jp, jcorpus, JPolicy(bits_k=2.0, bits_v=1.5,
                                                   group_size=16, window=32,
                                                   n_sink=5))
    ja, jkl = JN._agree(jp, jcfg, jnp.asarray(jtoks, jnp.int32),
                        J_METHODS[method], jcal, JPolicy(**kw))
    ta, tkl = TN._agree(tp, cfg, torch.from_numpy(toks.astype(np.int64)),
                        TB.METHODS[method],
                        [TC.LayerCalibration(**dataclasses.asdict(c))
                         for c in jcal], QuantPolicy(**kw))
    assert ta == ja
    assert tkl == pytest.approx(jkl, rel=1e-3, abs=1e-6)


def test_order_and_stages_are_the_reference_s():
    assert TL.ORDER == JL.ORDER
    assert TA.STAGES == JA.STAGES
    assert (TN.DEPTHS, TN.SEQ) == (JN.DEPTHS, JN.SEQ)
    assert TS.N_LAYERS == JS.N_LAYERS
    assert (TQ.BENCH_ARCH, TQ.TRAIN_STEPS, TQ.EVAL_BATCH, TQ.EVAL_SEQ) == (
        JC.BENCH_ARCH, JC.TRAIN_STEPS, JC.EVAL_BATCH, JC.EVAL_SEQ)
