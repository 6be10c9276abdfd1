"""The fake-quant baselines (``repro_torch.core.baselines``), the filter
rules (``core.filters``), the baseline switches of ``QuantPolicy`` and the
quality helpers ``kv_cache.gather_attention_inputs``/``materialize_kv``
against the JAX package on the same numpy inputs, on the CPU.

Tolerances, and why:

* Methods: atol 1e-6 x max|x| on f32 (the values reach ~1e3 on the
  outlier channels).  Every method is the same f32 operations on both
  sides around the byte-exact ``quantize_groups``; a code that flipped
  would move a value by a whole quantization step, far above the bound.
* Filters: masks EXACT.
* ``gather_attention_inputs``/``materialize_kv``: positions and masks
  EXACT; K/V EXACT by bit pattern in f32 and in bf16 (the fp segments
  are copies, the packed one the same dequant ``q * h + lo``), and a
  pooled cache gives the striped cache's result bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import baselines as JB
from repro.core import calibrate as JC
from repro.core import filters as JF
from repro.core import kv_cache as jkvc
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.policy import fp16_guard as j_fp16_guard

from repro_torch.core import baselines as TB
from repro_torch.core import calibrate as TC
from repro_torch.core import filters as TF
from repro_torch.core import kv_cache as kvc
from repro_torch.core.policy import (FP16_POLICY, PAPER_POLICY, QuantPolicy,
                                     fp16_guard)
from test_torch_util import assert_tree_exact, bits_of, j2t
from test_torch_util import (  # noqa: F401
    jax_cache_ops, jax_compile_cache, one_torch_thread)

METHOD_RTOL = 1e-6


@pytest.fixture(scope="module")
def kv_data():
    """tests/test_baselines.py's structured K/V: log-normal channel scales
    with two outlier channels, V's scales rolled."""
    rng = np.random.default_rng(7)
    b, s, h, d = 2, 256, 2, 64
    scales = np.exp(rng.normal(size=(1, 1, h, d)) * 1.2)
    scales[..., :2] *= 25
    k = (rng.normal(size=(b, s, h, d)) * scales).astype(np.float32)
    v = (rng.normal(size=(b, s, h, d)) * np.roll(scales, 7, -1)).astype(
        np.float32)
    return k, v


def _pols(**kw):
    return JPolicy(**kw), QuantPolicy(**kw)


def _samples(x):
    return x.reshape(-1, *x.shape[2:])


# ------------------------------------------------------------------ methods

@pytest.mark.parametrize("name", sorted(JB.METHODS))
def test_method_equals_jax(name, kv_data):
    k, v = kv_data
    jp, tp = _pols(bits_k=2.0, bits_v=2.0, group_size=32, window=32,
                   n_sink=2)
    cal = JC.calibrate_layer(_samples(k), _samples(v), jp)
    jk, jv = JB.METHODS[name](jnp.asarray(k), jnp.asarray(v),
                              JB.MethodCtx(jp, cal))
    tk, tv = TB.METHODS[name](torch.from_numpy(k), torch.from_numpy(v),
                              TB.MethodCtx(tp, cal))
    for got, want, x in ((tk, jk, k), (tv, jv, v)):
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=METHOD_RTOL * np.abs(x).max())


def test_method_at_paper_policy_with_mixed_width_values(rng):
    """SKVQ and RPTQ at PAPER_POLICY's widths (V 1.5-bit, two planes) and
    at fp16 metadata, D 128."""
    k = (rng.normal(size=(1, 160, 2, 128))
         * np.exp(rng.normal(size=(1, 1, 2, 128)))).astype(np.float32)
    v = rng.normal(size=(1, 160, 2, 128)).astype(np.float32)
    cal = JC.calibrate_layer(_samples(k), _samples(v), JPolicy(
        bits_k=2.0, bits_v=1.5, group_size=128))
    for fp8 in (True, False):
        jp, tp = _pols(bits_k=2.0, bits_v=1.5, group_size=128, window=16,
                       n_sink=5, fp8_meta=fp8)
        for name in ("skvq", "rptq"):
            jk, jv = JB.METHODS[name](jnp.asarray(k), jnp.asarray(v),
                                      JB.MethodCtx(jp, cal))
            tk, tv = TB.METHODS[name](torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      TB.MethodCtx(tp, cal))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                       atol=METHOD_RTOL * np.abs(k).max())
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                       atol=METHOD_RTOL * np.abs(v).max())


def _err(name, k, v, pol):
    cal = TC.calibrate_layer(_samples(k), _samples(v), pol)
    kq, vq = TB.METHODS[name](torch.from_numpy(k), torch.from_numpy(v),
                              TB.MethodCtx(pol, cal))
    rel = lambda a, b: float(((a - b) ** 2).sum() / (b ** 2).sum())
    return rel(kq, torch.from_numpy(k)) + rel(vq, torch.from_numpy(v))


def test_method_quality_ordering_in_the_port(kv_data):
    """tests/test_baselines.py's ordering, calibrated and measured in the
    port: SKVQ < RPTQ/KIVI < RTN in reconstruction error (Table 1)."""
    k, v = kv_data
    pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=32,
                      n_sink=2)
    errs = {m: _err(m, k, v, pol) for m in
            ("rtn", "smoothquant", "rptq", "kivi", "skvq")}
    assert errs["skvq"] < errs["rtn"] * 0.7, errs
    assert errs["skvq"] <= min(errs["rptq"], errs["kivi"]) * 1.05, errs
    assert _err("fp16", k, v, pol) == 0


def test_fp16_method_is_the_identity(kv_data):
    k, v = (torch.from_numpy(x) for x in kv_data)
    kq, vq = TB.METHODS["fp16"](k, v, TB.MethodCtx(QuantPolicy(), None))
    assert kq is k and vq is v


def test_rtn_sym_worse_than_asym_in_the_port():
    """Table 2: asymmetric beats symmetric at 2 bits on shifted channels."""
    rng = np.random.default_rng(3)
    shift = rng.uniform(2.0, 6.0, size=(1, 1, 2, 64))
    k = (rng.normal(size=(2, 256, 2, 64)) + shift).astype(np.float32)
    v = (rng.normal(size=(2, 256, 2, 64)) + shift).astype(np.float32)
    pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=0,
                      n_sink=0, clip=False, reorder=False)
    assert _err("rtn", k, v, pol) < _err("rtn_sym", k, v, pol)


def test_methods_quantize_through_the_resolved_quant_fn(kv_data,
                                                       monkeypatch):
    """Every quantizing method calls the quantizer that
    ``calibrate.resolve_quant_fn`` picks for the tensors' device (the
    kernel route on a card; here its host side, which runs the plain
    version and counts it) and nothing else."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_kernel_quant_fn
    k, v = (torch.from_numpy(x[:, :64]) for x in kv_data)
    pol = QuantPolicy(bits_k=2.0, bits_v=2.0, group_size=32, window=8,
                      n_sink=2)
    cal = TC.calibrate_layer(_samples(k), _samples(v), pol)
    ctx = TB.MethodCtx(pol, cal)
    want = {name: TB.METHODS[name](k, v, ctx)
            for name in ("rtn", "smoothquant", "rptq", "kivi", "skvq")}
    monkeypatch.setattr(TB, "resolve_quant_fn",
                        lambda qf, device: make_kernel_quant_fn())
    for name, w in want.items():
        reset_launch_counts()
        got = TB.METHODS[name](k, v, ctx)
        assert launch_counts()["kv_quant"]["plain"] == 2, name
        assert all(torch.equal(a, b) for a, b in zip(got, w)), name


# ------------------------------------------------------------------ filters

def test_filters_equal_jax(rng):
    pos = np.arange(64, dtype=np.int32)
    mass = rng.exponential(size=64).astype(np.float32)
    for q in (0.99, 0.9, 0.5, 0.0, 1.0):
        jfs = [JF.AttentionSinkFilter(5), JF.HeavyHitterFilter(q)]
        tfs = [TF.AttentionSinkFilter(5), TF.HeavyHitterFilter(q)]
        jstats, tstats = ({"attn_mass": jnp.asarray(mass)},
                          {"attn_mass": torch.from_numpy(mass)})
        for jf, tf in zip(jfs, tfs):
            np.testing.assert_array_equal(
                tf.keep_fp(torch.from_numpy(pos), tstats).numpy(),
                np.asarray(jf.keep_fp(jnp.asarray(pos), jstats)))
        got = TF.combine(tfs, torch.from_numpy(pos), tstats)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JF.combine(jfs, jnp.asarray(pos), jstats)))
    assert not TF.combine([], torch.from_numpy(pos), {}).any()


# ------------------------------------------------------------ policy switches

def test_baseline_switches_exclude_reorder_and_fp16_guard_clears_them():
    for bad in (dict(smooth=True), dict(per_channel_key=True)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            QuantPolicy(reorder=True, **bad)
        with pytest.raises(ValueError):
            JPolicy(reorder=True, **bad)
    for kw in (dict(smooth=True), dict(per_channel_key=True),
               dict(smooth=True, per_channel_key=True)):
        tp, jp = QuantPolicy(reorder=False, **kw), JPolicy(reorder=False, **kw)
        assert (tp.smooth, tp.per_channel_key) == (jp.smooth,
                                                   jp.per_channel_key)
        g, jg = fp16_guard(tp), j_fp16_guard(jp)
        assert g.is_fp16 and not (g.smooth or g.per_channel_key)
        assert (g.smooth, g.per_channel_key, g.reorder, g.clip) == \
            (jg.smooth, jg.per_channel_key, jg.reorder, jg.clip)
    assert not (FP16_POLICY.smooth or FP16_POLICY.per_channel_key)
    assert not (PAPER_POLICY.smooth or PAPER_POLICY.per_channel_key)
    assert QuantPolicy() == QuantPolicy(smooth=False, per_channel_key=False)


# --------------------------------------------------- attention inputs helpers

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
BT, MAX_LEN = 8, 60      # packed region 60 - 4 - 8 = 48 = 6 blocks of 8


@pytest.fixture(scope="module")
def caches():
    """A reference cache (B 3, H 2, D 32) prefilled with 30 tokens and
    grown by decode appends with ragged ``valid`` past a ring wrap, then
    the same cache in the paged pool: {"striped": jax, "pooled": jax}."""
    rng = np.random.default_rng(5)
    jp = JPolicy(**KW)
    b, s, h, d = 3, 30, 2, 32
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    ops = jax_cache_ops()
    cj = ops.prefill(jnp.asarray(k), jnp.asarray(v), MAX_LEN, jp)
    for step in range(11):
        kn = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        vn = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        valid = np.asarray([True, step % 3 != 1, step < 4])
        cj = ops.append(cj, jnp.asarray(kn), jnp.asarray(vn), jp,
                        valid=jnp.asarray(valid))
    return {"striped": cj, "pooled": _pooled(cj)}


def _pooled(cj):
    """The same cache in the paged pool: a scrambled block table, the
    packed blocks inserted per slot, sinks, ring and lengths copied."""
    jp = JPolicy(**KW)
    b, h = cj["length"].shape[0], cj["win_k"].shape[2]
    d = cj["win_k"].shape[3]
    nb = (MAX_LEN - KW["n_sink"] - KW["window"]) // BT
    tbl = (np.random.default_rng(1).permutation(b * nb) + 1).reshape(b, nb)
    pc = jkvc.init_pooled_cache(b, MAX_LEN, h, d, jp, b * nb + 1, BT,
                                jnp.float32)
    pc["block_tbl"] = jnp.asarray(tbl, jnp.int32)
    for i in range(b):
        pairs = np.stack([np.arange(nb), tbl[i]], axis=1).astype(np.int32)
        pc = jkvc.pool_insert_blocks(pc, cj, pairs, src_slot=i)
    for key in ("length", "sink_k", "sink_v", "win_k", "win_v"):
        pc[key] = cj[key]
    return pc


@pytest.mark.parametrize("layout", ["striped", "pooled"])
def test_gather_attention_inputs_equal_jax(layout, caches):
    striped = kvc.gather_attention_inputs(j2t(caches["striped"]), 32,
                                          QuantPolicy(**KW), torch.float32)
    cj = caches[layout]
    ct = j2t(cj)
    assert kvc.is_pooled(ct) == (layout == "pooled")
    names = ("k", "v", "pos", "valid")
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = kvc.gather_attention_inputs(ct, 32, QuantPolicy(**KW), dtype)
        want = jkvc.gather_attention_inputs(cj, 32, JPolicy(**KW), jdtype)
        assert [g.dtype for g in got] == [dtype, dtype, torch.int32,
                                          torch.bool]
        assert_tree_exact(dict(zip(names, got)), dict(zip(names, want)),
                          str(dtype))
    # the pooled cache reads back as the striped one
    got = kvc.gather_attention_inputs(ct, 32, QuantPolicy(**KW),
                                      torch.float32)
    assert all(torch.equal(g, s_) for g, s_ in zip(got, striped))


@pytest.mark.parametrize("layout", ["striped", "pooled"])
def test_materialize_kv_equals_jax(layout, caches):
    cj = caches[layout]
    total = int(np.asarray(cj["length"]).max())
    want = jkvc.materialize_kv(cj, 32, JPolicy(**KW), total)
    got = kvc.materialize_kv(j2t(cj), 32, QuantPolicy(**KW), total)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(bits_of(g.numpy()), bits_of(w))
    # the fp segments come back verbatim at their positions
    lens = np.asarray(cj["length"])
    k = got[0].numpy()
    np.testing.assert_array_equal(k[:, :KW["n_sink"]],
                                  np.asarray(cj["sink_k"]))
    for row, n in enumerate(lens):
        assert not k[row, n:].any()
