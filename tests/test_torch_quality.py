"""The port's quality evaluator (``repro_torch.quality.common``: the
position-correct proxy perplexity, per-layer calibration, the bench model's
cache) against the reference harness ``benchmarks/common.py`` on the same
inputs, on the CPU; and the kernel route's exact split of rows wider than
the bulk quantizer takes (KIVI's per-channel keys at a long context).

The model is the studies' own stand-in (2 layers, d 128, 4 heads / 2 kv of
32), trained 60 steps by the reference's ``train_or_restore`` into a
temporary directory and carried across; both sides quantize with the
reference's calibration tables carried across.

Tolerances, and why:

* ``eval_tokens``, ``bits_breakdown``, permutations, clip factors and the
  smoothing factors: EXACT (the same numpy draws; the reference's numpy
  statistics and k-means on the same samples; the clip search over the
  byte-exact quantizer).
* ``_windowed_attention``: rtol 1e-5 with atol 1e-5 x max|o| (f32 scores
  and softmax; torch and XLA sum the products in other orders).
* ``ppl_with_method`` / ``ppl_with_schedule``: relative 1e-4 (``PPL_RTOL``),
  and each layer's fake-quantized K and V may differ from the reference's
  by more than 1e-3 x max|x| (a flipped code, a whole quantization step) in
  at most ``FLIP_RATE`` of the elements, the bound of
  tests/test_torch_model.py: the f32 forwards differ in the last bits, so
  a value on a rounding edge can flip a code.
* the uniform schedule against the port's own SKVQ row: 1e-6 absolute,
  the reference's own regression (it is the same computation).
* a second ``train_or_restore`` restores the checkpoint bit for bit.
"""
import dataclasses
import sys
import types
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
from repro import configs as jconfigs                    # noqa: E402
from repro.core.baselines import METHODS as J_METHODS    # noqa: E402
from repro.core.policy import PolicySchedule as JSchedule  # noqa: E402
from repro.core.policy import QuantPolicy as JPolicy     # noqa: E402
from repro.core.policy import fp16_guard as j_fp16_guard  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus        # noqa: E402
from repro.models import transformer as JT               # noqa: E402

from repro_torch.convert import params_from_numpy        # noqa: E402
from repro_torch.core import baselines as TB             # noqa: E402
from repro_torch.core import calibrate as TC             # noqa: E402
from repro_torch.core.policy import (PolicySchedule, QuantPolicy,  # noqa: E402
                                     fp16_guard)
from repro_torch.core.quant import quantize_groups       # noqa: E402
from repro_torch.data import SyntheticCorpus             # noqa: E402
from repro_torch.kernels import ops                      # noqa: E402
from repro_torch.quality import common as TQ             # noqa: E402
from repro_torch.quality import schedule_quality as TS   # noqa: E402
from repro_torch.tree import leaves                      # noqa: E402
from test_torch_util import (  # noqa: F401,E402
    jax_compile_cache, one_torch_thread)

CPU = "cpu"
TRAIN = 60
PPL_RTOL = 1e-4
FLIP_RATE = 5e-3
FLIP_STEP = 1e-3
KW = dict(bits_k=2.0, bits_v=2.0, group_size=16, window=32, n_sink=5)


def _jcfg():
    return jconfigs.get_smoke(JC.BENCH_ARCH).scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The stand-in trained by the reference, both sides' params, the
    corpus, the eval tokens and the reference's calibration at ``KW``."""
    cache = tmp_path_factory.mktemp("bench") / "ref"
    jcfg = _jcfg()
    corpus = JCorpus(jcfg.vocab_size, seed=11)
    jp = JC.train_or_restore(str(cache), jcfg, corpus, TRAIN)
    cfg = TQ.bench_config()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    toks = np.asarray(JC.eval_tokens(corpus))
    jcal = JC.calibrate(jcfg, jp, corpus, JPolicy(**KW))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, cache=cache, toks=toks,
        corpus=SyntheticCorpus(cfg.vocab_size, seed=11), jcorpus=corpus,
        jcal=jcal, tcal=_tcal(jcal))


def _tcal(jcal):
    return [TC.LayerCalibration(**dataclasses.asdict(c)) for c in jcal]


def _recorder(method, seen):
    def rec(k, v, ctx):
        kq, vq = method(k, v, ctx)
        seen.append(tuple(np.asarray(x, np.float32) for x in (k, kq, v, vq)))
        return kq, vq
    return rec


def _flip_rate(got, want):
    """Largest share, over layers and K/V, of fake-quantized values that
    differ by more than FLIP_STEP x max|x| (a flipped code)."""
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        for i in (1, 3):
            thr = FLIP_STEP * np.abs(w[i - 1]).max()
            worst = max(worst, float(np.mean(np.abs(g[i] - w[i]) > thr)))
    return worst


# ------------------------------------------------------------ eval_tokens

@pytest.mark.parametrize("n,s,seed", [(8, 256, 999), (8, 128, 12345),
                                      (3, 40, 7)])
def test_eval_tokens_equal_the_reference(n, s, seed):
    jc, tc = JCorpus(256, seed=11), SyntheticCorpus(256, seed=11)
    want = np.asarray(JC.eval_tokens(jc, n, s, seed))
    got = TQ.eval_tokens(tc, n, s, seed, device=CPU)
    assert got.device.type == "cpu" and got.shape == (n, s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eval_tokens_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TQ.eval_tokens(SyntheticCorpus(256, seed=11), 1, 8)


def test_bench_model_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TQ.bench_model(tmp_path / "m")
    assert not (tmp_path / "m").exists()


# ---------------------------------------------------- _windowed_attention

@pytest.mark.parametrize("query_scale", [0.0, 0.3])
@pytest.mark.parametrize("sinks", [0, 5])
@pytest.mark.parametrize("window", [0, 8, 32])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_windowed_attention_equals_the_reference(hq, hkv, window, sinks,
                                                 query_scale):
    rng = np.random.default_rng(hq * 100 + hkv * 10 + window + sinks)
    b, s, d = 2, 48, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k, v, kq, vq = (rng.normal(size=(b, s, hkv, d)).astype(np.float32)
                    for _ in range(4))
    cfg = types.SimpleNamespace(query_scale=query_scale)
    want = np.asarray(JC._windowed_attention(
        *map(jnp.asarray, (q, k, v, kq, vq)), window, sinks, cfg))
    got = TQ._windowed_attention(*map(torch.from_numpy, (q, k, v, kq, vq)),
                                 window, sinks, cfg)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_windowed_attention_is_causal_attention_when_nothing_is_quantized():
    """With kq/vq = k/v the mix is plain causal softmax attention, whatever
    the window and sinks."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    cfg = types.SimpleNamespace(query_scale=0.0)
    s = torch.einsum("bshd,bthd->bhst", q, k) * 8 ** -0.5
    s = s.masked_fill(~torch.ones(20, 20, dtype=torch.bool).tril(), -1e30)
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    for window, sinks in ((0, 0), (8, 2), (32, 5)):
        got = TQ._windowed_attention(q, k, v, k, v, window, sinks, cfg)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ ppl_with_method

@pytest.mark.parametrize("name", sorted(J_METHODS))
def test_ppl_with_method_equals_the_reference(name, model):
    jseen, tseen = [], []
    want = JC.ppl_with_method(model.jp, model.jcfg, jnp.asarray(model.toks),
                              _recorder(J_METHODS[name], jseen),
                              calibs=model.jcal, policy=JPolicy(**KW))
    got = TQ.ppl_with_method(model.tp, model.cfg,
                             torch.from_numpy(model.toks),
                             _recorder(TB.METHODS[name], tseen),
                             calibs=model.tcal, policy=QuantPolicy(**KW))
    assert got == pytest.approx(want, rel=PPL_RTOL)
    assert _flip_rate(tseen, jseen) <= FLIP_RATE


def test_method_rows_are_ordered_as_the_reference(model):
    """The trained stand-in separates the methods by far more than the
    tolerance, so the comparison above tells them apart: fp16 and SKVQ
    below RTN, RTN-sym the worst."""
    toks = torch.from_numpy(model.toks)
    ppl = {n: TQ.ppl_with_method(model.tp, model.cfg, toks, TB.METHODS[n],
                                 calibs=model.tcal, policy=QuantPolicy(**KW))
           for n in ("fp16", "rtn", "rtn_sym", "skvq")}
    assert ppl["skvq"] < ppl["rtn"] and ppl["fp16"] < ppl["rtn"]
    assert ppl["rtn_sym"] > ppl["rtn"] * (1 + 100 * PPL_RTOL), ppl


def test_forward_refuses_other_families():
    from repro_torch import configs
    cfg = configs.get_smoke("deepseek_moe_16b")
    with pytest.raises(ValueError, match="dense family only"):
        TQ.forward_with_method({}, cfg, torch.zeros((1, 4), dtype=torch.long),
                               TB.METHODS["fp16"])


def test_methods_get_the_policy_without_its_window(model):
    """The window and sinks are mixed only in ``_windowed_attention``: the
    method's context holds ``pol.without_window()``."""
    seen = []

    def spy(k, v, ctx):
        seen.append(ctx.policy)
        return k, v
    TQ.forward_with_method(model.tp, model.cfg,
                           torch.from_numpy(model.toks[:1, :16]), spy,
                           calibs=model.tcal, policy=QuantPolicy(**KW))
    assert seen == [QuantPolicy(**KW).without_window()] * 2


def test_quant_fn_reaches_every_fake_quant(model):
    """``quant_fn`` is what every method of the evaluator quantizes through
    (on the card, the bulk kernel: ``resolve_quant_fn``), 2 calls a layer."""
    calls = []

    def spy(*args):
        calls.append(args[1:3])
        return quantize_groups(*args)
    toks = torch.from_numpy(model.toks[:2])
    for name in ("rtn", "smoothquant", "rptq", "kivi", "skvq"):
        calls.clear()
        with_spy = TQ.ppl_with_method(model.tp, model.cfg, toks,
                                      TB.METHODS[name], calibs=model.tcal,
                                      policy=QuantPolicy(**KW), quant_fn=spy)
        plain = TQ.ppl_with_method(model.tp, model.cfg, toks,
                                   TB.METHODS[name], calibs=model.tcal,
                                   policy=QuantPolicy(**KW))
        assert len(calls) == 2 * model.cfg.n_layers, name
        assert with_spy == plain


# ----------------------------------------------------- calibrate_schedule

def _schedules(jp_kw, n):
    jpol, tpol = JPolicy(**jp_kw), QuantPolicy(**jp_kw)
    ladder = ((4.0, 4.0),) + ((2.0, 2.0),) * (n - 1)
    return {
        "uniform": (JSchedule.uniform(jpol, n), PolicySchedule.uniform(tpol, n)),
        "guard_first_fp16": (
            JSchedule((j_fp16_guard(jpol),) + (jpol,) * (n - 1)),
            PolicySchedule((fp16_guard(tpol),) + (tpol,) * (n - 1))),
        "ladder_k4_first": (JSchedule.bits_ladder(jpol, ladder, n),
                            PolicySchedule.bits_ladder(tpol, ladder, n)),
    }


@pytest.fixture(scope="module")
def samples(model):
    """The reference's calibration samples (its ``calibrate_schedule``'s
    own draw), as numpy."""
    toks = JC.eval_tokens(model.jcorpus, n=8, s=128, seed=12345)
    ks, vs = JT.collect_kv(model.jp, model.jcfg, {"tokens": toks})
    return np.asarray(ks), np.asarray(vs)


def _feed(monkeypatch, model, kv):
    """Make the port's ``collect_kv`` hand ``calibrate_schedule`` the
    samples ``kv`` (so both sides calibrate on equal K/V); returns the
    tokens it was asked for and the reference's calibration tokens."""
    from repro_torch.models import transformer as T
    want = JC.eval_tokens(model.jcorpus, n=8, s=128, seed=12345)
    calls = []

    def collect(params, cfg, toks):
        calls.append(toks)
        return kv
    monkeypatch.setattr(T, "collect_kv", collect)
    return calls, want


@pytest.mark.parametrize("which", ["uniform", "guard_first_fp16",
                                   "ladder_k4_first"])
def test_calibrate_schedule_equals_the_reference(which, model, samples,
                                                 monkeypatch):
    jsched, tsched = _schedules(KW, model.cfg.n_layers)[which]
    want = JC.calibrate_schedule(model.jcfg, model.jp, model.jcorpus, jsched)
    _feed(monkeypatch, model, samples)
    got = TQ.calibrate_schedule(model.cfg, model.tp, model.corpus, tsched)
    assert len(got) == len(want) == model.cfg.n_layers
    for l, (g, w) in enumerate(zip(got, want)):
        for f in ("perm_k", "perm_v", "alpha_k", "alpha_v", "smooth_k"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (l, f)
            np.testing.assert_array_equal(a, b, err_msg=f"layer {l} {f}")


def test_calibrate_seeds_layer_l_with_seed_plus_l(model, samples,
                                                 monkeypatch):
    """Layer l's permutations come from seed ``seed + l`` (not
    ``calibrate_model``'s ``seed + 31 l``), and ``calibrate`` is the
    uniform schedule."""
    pol = QuantPolicy(**KW)
    _feed(monkeypatch, model, samples)
    got = TQ.calibrate(model.cfg, model.tp, model.corpus, pol, seed=4)
    for l in range(model.cfg.n_layers):
        one = TC.calibrate_layer(samples[0][l], samples[1][l], pol,
                                 seed=4 + l)
        for f in ("perm_k", "perm_v", "alpha_k", "alpha_v"):
            np.testing.assert_array_equal(getattr(got[l], f),
                                          getattr(one, f))


def test_calibrate_schedule_collects_its_own_samples(model, samples,
                                                    monkeypatch):
    """The port collects its samples over the reference's tokens with its
    own ``collect_kv``; its K/V differ from the reference's in the last
    bits only, and layer l is calibrated on layer l's samples."""
    from repro_torch.models import transformer as T
    toks = TQ.eval_tokens(model.corpus, n=8, s=128, seed=12345, device=CPU)
    ks, vs = T.collect_kv(model.tp, model.cfg, toks)
    np.testing.assert_allclose(ks.numpy(), samples[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(vs.numpy(), samples[1], atol=1e-4, rtol=1e-4)
    calls, want_toks = _feed(monkeypatch, model, (ks, vs))
    got = TQ.calibrate_schedule(model.cfg, model.tp, model.corpus,
                                QuantPolicy(**KW))
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0].numpy(), want_toks)
    for l, g in enumerate(got):
        w = TC.calibrate_layer(ks[l], vs[l], QuantPolicy(**KW), seed=l)
        np.testing.assert_array_equal(g.perm_k, w.perm_k)
        np.testing.assert_array_equal(g.alpha_v, w.alpha_v)


# ------------------------------------------------------ ppl_with_schedule

@pytest.mark.parametrize("which", ["guard_first_fp16", "ladder_k4_first"])
def test_ppl_with_schedule_equals_the_reference(which, model, samples):
    jsched, tsched = _schedules(KW, model.cfg.n_layers)[which]
    jcal = JC.calibrate_schedule(model.jcfg, model.jp, model.jcorpus, jsched)
    jseen, tseen = [], []
    jpick = lambda i: (_recorder(J_METHODS["fp16" if jsched[i].is_fp16
                                           else "skvq"], jseen), jsched[i])
    tpick = lambda i: (_recorder(TB.METHODS["fp16" if tsched[i].is_fp16
                                            else "skvq"], tseen), tsched[i])
    want = JC._ppl(JC._layer_mixed_forward(
        model.jp, model.jcfg, jnp.asarray(model.toks), jpick, jcal),
        jnp.asarray(model.toks))
    toks = torch.from_numpy(model.toks)
    got = TQ._ppl(TQ._layer_mixed_forward(model.tp, model.cfg, toks, tpick,
                                          _tcal(jcal)), toks)
    assert got == pytest.approx(want, rel=PPL_RTOL)
    assert _flip_rate(tseen, jseen) <= FLIP_RATE
    assert TQ.ppl_with_schedule(model.tp, model.cfg, toks, tsched,
                                calibs=_tcal(jcal)) == got


def test_uniform_schedule_is_the_skvq_row(model):
    toks = torch.from_numpy(model.toks)
    pol = QuantPolicy(**KW)
    skvq = TQ.ppl_with_method(model.tp, model.cfg, toks, TB.METHODS["skvq"],
                              calibs=model.tcal, policy=pol)
    uni = TQ.ppl_with_schedule(model.tp, model.cfg, toks,
                               PolicySchedule.uniform(pol, model.cfg.n_layers),
                               calibs=model.tcal)
    assert abs(uni - skvq) < 1e-6


@pytest.mark.parametrize("which", ["uniform", "guard_first_fp16",
                                   "ladder_k4_first"])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_bits_breakdown_equals_the_reference(which, head_dim):
    for kw in (KW, dict(bits_k=2.0, bits_v=1.5, group_size=128, window=128,
                        n_sink=5)):
        jsched, tsched = _schedules(kw, 4)[which]
        assert (TQ.bits_breakdown(tsched, head_dim)
                == JC.bits_breakdown(jsched, head_dim))


# ------------------------------------------------------- train_or_restore

def test_train_or_restore_restores_bitwise_without_training(tmp_path,
                                                            monkeypatch):
    cfg = TQ.bench_config()
    corpus = SyntheticCorpus(cfg.vocab_size, seed=11)
    first = TQ.train_or_restore(tmp_path / "m", cfg, corpus, 3, device=CPU)
    assert any(p.name.startswith("step_") for p in (tmp_path / "m").iterdir())

    def no_training(*a, **k):
        raise AssertionError("the second call trained")
    monkeypatch.setattr(TQ, "make_train_step", no_training)
    again = TQ.train_or_restore(tmp_path / "m", cfg, corpus, 3, device=CPU)
    for a, b in zip(leaves(first), leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_or_restore_reads_the_reference_checkpoint(model, monkeypatch):
    """The port restores the reference's checkpoint of the stand-in (the
    same layout) without training, bit for bit."""
    monkeypatch.setattr(TQ, "make_train_step", None)
    got = TQ.train_or_restore(model.cache, model.cfg, model.corpus, TRAIN,
                              device=CPU)
    for a, b in zip(leaves(got), leaves(model.tp)):
        assert torch.equal(a, b)


def test_the_step_count_keys_the_schedule_model_directory(tmp_path):
    assert TS.sched_dir(120, tmp_path / "s") == f"{tmp_path / 's'}_120"
    assert TS.sched_dir(120, tmp_path / "s") != TS.sched_dir(300,
                                                              tmp_path / "s")
    assert TS.sched_dir(300).endswith("experiments/schedule_model_torch_300")
    assert str(TQ.BENCH_DIR).endswith("experiments/bench_model_torch")


# ----------------------------------- the kernel route's split of long rows

@pytest.mark.parametrize("alpha", ["none", "scalar", "shared", "per_head",
                                   "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_splits_long_rows_exactly(alpha, dtype):
    """Rows of 2048 channels at 2 bits, group 128 (KIVI's keys at a
    2048-token context): cut into rows of 256 they give the plain
    quantizer's bytes for the whole row, clip factors carried along."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 4, 2048)).astype(np.float32)
                         ).to(dtype)
    g = 2048 // 128
    a = {"none": None, "scalar": torch.tensor(0.9),
         "shared": torch.from_numpy(rng.uniform(0.6, 1.0, g)
                                    .astype(np.float32)),
         "per_head": torch.from_numpy(rng.uniform(0.6, 1.0, (4, g))
                                      .astype(np.float32)),
         "per_row": torch.from_numpy(rng.uniform(0.6, 1.0, (3, 4, g))
                                     .astype(np.float32))}[alpha]
    assert ops.split_width(2048, 2.0, 128) == 256
    got = ops.make_kernel_quant_fn()(x, 2.0, 128, a, True)
    want_alpha = a
    if alpha == "per_head":
        want_alpha = a.expand(3, 4, g)
    want = quantize_groups(x, 2.0, 128, want_alpha, True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].view(torch.uint8),
                           want[k].view(torch.uint8)), k


@pytest.mark.parametrize("d,bits,gs", [(2048, 1.5, 128), (1024, 2.0, 512),
                                       (300, 2.0, 300)])
def test_kernel_route_refuses_rows_with_no_exact_split(d, bits, gs):
    x = torch.zeros((2, d))
    with pytest.raises(ValueError, match="no exact split"):
        ops.make_kernel_quant_fn()(x, bits, gs, None, True)


def test_kivi_on_the_kernel_route_at_a_long_context():
    """KIVI at S 512 (token rows wider than the kernel takes) through the
    kernel route (its plain twin here) equals the plain quantizer."""
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.normal(size=(1, 512, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 512, 2, 32)).astype(np.float32))
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=128,
                      n_sink=5)
    plain = TB.kivi(k, v, TB.MethodCtx(pol))
    kern = TB.kivi(k, v, TB.MethodCtx(pol, None, ops.make_kernel_quant_fn()))
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
