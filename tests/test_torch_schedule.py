"""The port's per-layer policy schedules (DESIGN.md §8) against the JAX
package on the same seeded numpy inputs: the schedule types and presets,
banded prefill / decode / chunked prefill with band-keyed caches, the fp16
route of the guard layers, the scheduled Engine striped and pooled (one
pool per quantized band), the CLI's ``--policy-schedule``, and the
``granite_8b`` config.  Mirrors tests/test_policy_schedule.py.

Tolerances, and why:
* schedule accounting, band keys, lengths, greedy tokens: EXACT;
* quantized bands' codes and scale/zero bytes: EXACT.  The K/V that reach
  the quantizer differ from JAX's by f32 matmul order only (< 1e-5 here),
  and per-token group quantization gives the same bytes unless a value
  sits on a rounding edge, which none of these seeded inputs does;
* fp16 bands' ``k``/``v`` and the fp sink/window buffers: ``atol = rtol
  = 1e-5`` (the same f32 values up to matmul order);
* prefill and decode logits: ``atol = rtol = 2e-4`` (tests/test_torch_model
  .py's bound, for the same reason);
* the fp16 decode fallback against ``pallas_decode_attention``: f32
  ``atol = rtol = 1e-5`` (the same flash partial, summed in another order);
* a uniform schedule against the bare policy, pooled against striped,
  the fp16 bulk chunk write against the token loop: BITWISE.
The card-only cases (both kernels at the ladder's widths) are in
``chip_smoke.py``.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import kv_cache as jkvc
from repro.core import policy as jpol
from repro.core.quant import n_meta_groups
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch
from repro.serving import Engine as JEngine, Request as JRequest

from repro_torch import configs
from repro_torch.convert import calib_from_numpy, params_from_numpy
from repro_torch.core import kv_cache as kvc
from repro_torch.core import policy as tpol
from repro_torch.core.policy import (FP16_POLICY, PAPER_POLICY, PolicySchedule,
                                     QuantPolicy, SchedulePreset, as_layer_policy,
                                     as_schedule, fp16_guard)
from repro_torch.kernels import kv_quant as KQ
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.launch import serve as tserve
from repro_torch.models import backends as bk
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serving import Engine, Request
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
SHAPE = dict(name="t", family="dense", n_layers=4, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
LOGIT_TOL = 2e-4
FP_TOL = 1e-5
# first_last_fp16 with one guard layer: bands [0,1) fp16, [1,3), [3,4) fp16;
# the default ladder on 4 layers: [0,2) 4/4, [2,3) 2/2, [3,4) 2/1.5
SCHEDULES = {
    "guard": lambda m, pol: m.PolicySchedule.first_last_fp16(pol, 1, 4),
    "ladder": lambda m, pol: m.PolicySchedule.bits_ladder(pol, n_layers=4)}
BACKENDS = [("reference", "reference"), ("cuda", "pallas")]


def _scheds(name):
    return (SCHEDULES[name](jpol, jpol.QuantPolicy(**KW)),
            SCHEDULES[name](tpol, QuantPolicy(**KW)))


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _fields(p):
    return (p.bits_k, p.bits_v, p.group_size, p.window, p.n_sink,
            p.fp8_meta, p.clip, p.reorder)


# ------------------------------------------------ types, presets, coercion

@pytest.mark.parametrize("n", [4, 6, 32])
def test_presets_materialize_like_jax(n):
    """Every preset gives the reference's per-layer policies, bands and
    distinct policies at several depths."""
    for name, args in (("first_last_fp16", (1,)), ("first_last_fp16", (2,)),
                       ("bits_ladder", ()), ("uniform", ())):
        if name == "first_last_fp16" and 2 * args[0] >= n:
            continue
        jpre = getattr(jpol.PolicySchedule, name)(jpol.PAPER_POLICY, *args)
        tpre = getattr(PolicySchedule, name)(PAPER_POLICY, *args)
        assert isinstance(tpre, SchedulePreset) and tpre.kind == jpre.kind
        js, ts = jpol.as_schedule(jpre, n), as_schedule(tpre, n)
        assert [_fields(p) for p in ts] == [_fields(p) for p in js], name
        assert ([(a, b, _fields(p)) for a, b, p in ts.bands()]
                == [(a, b, _fields(p)) for a, b, p in js.bands()])
        assert len(ts.distinct()) == len(js.distinct())
        assert ts.is_uniform == js.is_uniform


def test_bands_distinct_hash_and_coercion():
    pol = QuantPolicy(**KW)
    s = as_schedule(pol, 4)
    assert isinstance(s, PolicySchedule) and s.is_uniform and len(s) == 4
    assert s == PolicySchedule.uniform(pol, 4)
    assert {s: 1}[as_schedule(pol, 4)] == 1          # hashable, value-keyed
    assert as_schedule(s, 4) is s
    assert as_schedule([pol] * 4, 4) == s
    g = PolicySchedule.first_last_fp16(pol, 1, 4)
    assert [(a, b) for a, b, _ in g.bands()] == [(0, 1), (1, 3), (3, 4)]
    assert [(a, b) for a, b, _ in g.bands(1, 3)] == [(1, 3)]
    assert g.bands()[0][2] == fp16_guard(pol) and g.bands()[0][2].is_fp16
    assert len(g.distinct()) == 2 and not g.is_uniform
    assert hash(g) == hash(PolicySchedule.first_last_fp16(pol, 1, 4))
    assert as_layer_policy(PolicySchedule.uniform(pol, 3)) == pol
    assert fp16_guard(PAPER_POLICY) == FP16_POLICY.__class__(
        bits_k=16.0, bits_v=16.0, group_size=128, window=0, n_sink=0,
        clip=False, reorder=False)


def test_for_arch_on_dense_and_local_configs():
    pol = QuantPolicy(**KW)
    for arch in ("granite_8b", "llama2_7b"):
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        ts = PolicySchedule.for_arch(pol, cfg)
        js = jpol.PolicySchedule.for_arch(jpol.QuantPolicy(**KW), jcfg)
        assert ts.is_uniform and len(ts) == cfg.n_layers == len(js)
        assert [_fields(p) for p in ts] == [_fields(p) for p in js]
    local = TCFG.scaled(local_window=4, local_pattern=(1, 0))
    assert [p.window for p in PolicySchedule.for_arch(pol, local)] \
        == [4, 8, 4, 8]


@pytest.mark.parametrize("name", ["guard", "ladder"])
def test_schedule_accounting_equals_jax(name):
    """avg-bits, per-layer packed bytes, the layer table and the cache
    bytes per layer equal the reference's, for first_last_fp16(PAPER, 1)
    and the default ladder."""
    mk = {"guard": lambda m: m.PolicySchedule.first_last_fp16(
              m.PAPER_POLICY, 1, 6),
          "ladder": lambda m: m.PolicySchedule.bits_ladder(
              m.PAPER_POLICY, n_layers=6)}[name]
    js, ts = mk(jpol), mk(tpol)
    for hd, nkv in ((128, 32), (128, 8), (32, 2)):
        assert ts.avg_bits(hd) == js.avg_bits(hd)
        assert ts.layer_avg_bits(hd) == js.layer_avg_bits(hd)
        assert ts.layer_kv_bytes(hd, nkv) == js.layer_kv_bytes(hd, nkv)
        assert ts.kv_bytes_per_token(hd, nkv) == js.kv_bytes_per_token(hd,
                                                                       nkv)
        assert ts.layer_table(hd, nkv) == js.layer_table(hd, nkv)
        assert (kvc.schedule_cache_nbytes(ts, 6, 300, nkv, hd)
                == jkvc.schedule_cache_nbytes(js, 6, 300, nkv, hd))
    per = ts.layer_avg_bits(128)
    assert ts.avg_bits(128) == pytest.approx(sum(per) / 6)
    if name == "guard":
        assert per[0] == per[5] == 16.0
        assert ts.layer_kv_bytes(128, 32)[0] == 2 * 2 * 128 * 32


def test_schedule_errors_match_jax():
    pol, jp = QuantPolicy(**KW), jpol.QuantPolicy(**KW)
    cases = [
        (lambda m, p: m.as_schedule(m.PolicySchedule.first_last_fp16(p, 2),
                                    4), ValueError, "NO quantized layers"),
        (lambda m, p: m.PolicySchedule.first_last_fp16(p, -1), ValueError,
         "n_guard"),
        (lambda m, p: m.PolicySchedule.bits_ladder(p, ()), ValueError,
         "at least one"),
        (lambda m, p: m.as_schedule(m.PolicySchedule.uniform(p, 4), 6),
         ValueError, "covers 4 layers"),
        (lambda m, p: m.as_layer_policy(
            m.PolicySchedule.first_last_fp16(p, 1, 4)), TypeError,
         "per-layer"),
        (lambda m, p: m.PolicySchedule(()), ValueError, "at least one"),
        (lambda m, p: m.as_schedule("uniform", 4), TypeError, "expected"),
    ]
    for fn, exc, msg in cases:
        with pytest.raises(exc) as want:
            fn(jpol, jp)
        with pytest.raises(exc, match=msg) as got:
            fn(tpol, pol)
        assert str(got.value) == str(want.value)


def test_stacked_calib_rejects_mixed_bit_layouts(params):
    """One stacked calib table cannot serve mixed quantized layouts; fp16
    guard layers are exempt (the reference's rule and message)."""
    _, tp = params
    toks = torch.zeros((1, 10), dtype=torch.int64)
    pol = QuantPolicy(**KW)
    calib = T.identity_calib(TCFG, pol, device="cpu")
    mixed = PolicySchedule.bits_ladder(pol, ((4.0, 4.0), (2.0, 1.5)), 4)
    for call in (lambda: T.prefill_model(tp, TCFG, toks, mixed, calib=calib,
                                         max_len=32),
                 lambda: Engine(tp, TCFG, mixed, batch_slots=1, max_len=32,
                                calib=calib, device="cpu")):
        with pytest.raises(ValueError, match="quantization layouts"):
            call()
    guard = PolicySchedule.first_last_fp16(pol, 1, 4)
    T.prefill_model(tp, TCFG, toks, guard, calib=calib, max_len=32)
    holder = type("Calibration", (), {"stacked": lambda self: calib})()
    assert T.stacked_calib(holder, TCFG) is calib


# ------------------------------------------------ banded passes against JAX

def _calib_np(rng, sched_t):
    """A non-identity stacked calib table for schedules with one quantized
    layout; None (identity per band) otherwise."""
    lay = {(p.bits_k, p.bits_v) for p in sched_t if not p.is_fp16}
    if len(lay) > 1:
        return None, None
    (bk_, bv), = lay
    n, h, d = 4, 2, 32
    perm = lambda: np.stack([np.stack([rng.permutation(d) for _ in range(h)])
                             for _ in range(n)]).astype(np.int32)
    gk, gv = (n_meta_groups(d, bits, 16) for bits in (bk_, bv))
    cal = {"perm_k": perm(), "perm_v": perm(),
           "alpha_k": rng.uniform(0.8, 1.0, (n, h, gk)).astype(np.float32),
           "alpha_v": rng.uniform(0.8, 1.0, (n, h, gv)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in cal.items()},
            calib_from_numpy(cal, device="cpu"))


def _compare_band_caches(ct, cj):
    """Band keys equal; quantized bands' bytes exact, fp values within
    FP_TOL, lengths exact."""
    cj = jax.tree.map(np.asarray, cj)
    assert sorted(ct) == sorted(cj)
    for bkey in cj:
        assert sorted(ct[bkey]) == sorted(cj[bkey]), bkey
        for k, want in cj[bkey].items():
            got = t2n(ct[bkey][k])
            if want.dtype.kind in "ui":
                np.testing.assert_array_equal(got, want, err_msg=f"{bkey}/{k}")
            else:
                np.testing.assert_allclose(got, want, atol=FP_TOL, rtol=FP_TOL,
                                           err_msg=f"{bkey}/{k}")


@pytest.mark.parametrize("name", ["guard", "ladder"])
@pytest.mark.parametrize("tb,jb", BACKENDS, ids=["reference", "cuda"])
def test_banded_prefill_and_decode_equal_jax(params, rng, name, tb, jb):
    """Band-keyed prefill caches, prefill logits, and three decode steps'
    logits and caches against the JAX package under the same schedule."""
    jp, tp = params
    js, ts = _scheds(name)
    jcal, tcal = _calib_np(rng, ts)
    toks = rng.integers(0, 64, (2, 30)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t, c: JT.prefill_model(
        p, JCFG, {"tokens": t}, js, calib=c, max_len=48, backend=jb))(
        jp, jnp.asarray(toks), jcal)
    lt, ct = T.prefill_model(tp, TCFG, torch.from_numpy(toks).long(), ts,
                             calib=tcal, max_len=48, backend=tb)
    np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _compare_band_caches(ct["scan"], cj["scan"])
    assert len(ct["scan"]) == 3                      # three bands
    step = jax.jit(lambda c, t: JT.decode_step(jp, JCFG, t, c, js,
                                               calib=jcal, backend=jb))
    tok = np.asarray(lj[:, -1].argmax(-1))[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = step(cj, jnp.asarray(tok))
        lt, ct = T.decode_step(tp, TCFG, torch.from_numpy(tok).long(), ct, ts,
                               calib=tcal, backend=tb)
        np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        tok = np.asarray(lj[:, -1].argmax(-1))[:, None].astype(np.int32)
    _compare_band_caches(ct["scan"], cj["scan"])


def test_guard_bands_hold_raw_kv(params, rng):
    """first_last_fp16's guard bands keep ``{length, k, v}`` in the compute
    dtype; the interior band packs planes (the reference's structure)."""
    _, tp = params
    _, ts = _scheds("guard")
    toks = torch.as_tensor(rng.integers(0, 64, (1, 14)))
    _, c = T.prefill_model(tp, TCFG, toks, ts, max_len=40)
    g = c["scan"]
    assert sorted(g) == ["L000", "L001", "L003"]
    for key in ("L000", "L003"):
        assert sorted(g[key]) == ["k", "length", "v"]
        assert g[key]["k"].dtype == torch.float32
        assert tuple(g[key]["k"].shape) == (1, 1, 40, 2, 32)
    assert g["L001"]["qk_codes_hi"].shape[0] == 2     # two stacked layers
    assert T.cache_bytes(c) == sum(T.cache_bytes(v) for v in g.values())


@pytest.mark.parametrize("name", ["guard", "ladder"])
def test_banded_chunked_prefill_equals_jax(params, rng, name):
    """Banded chunked prefill against the JAX package's chunked prefill
    under the same schedule (not against whole-prompt prefill: that
    cross-path bit claim fails in the reference, ROADMAP §3): a 37-token
    prompt in chunks of 16 (the tail of 5 padded to 8), both backends."""
    jp, tp = params
    js, ts = _scheds(name)
    prompt = rng.integers(0, 64, 37).astype(np.int32)
    fn = jax.jit(lambda st, tk, a, b: JT.prefill_chunk(
        jp, JCFG, tk, st, js, a, b, backend="reference"))
    jst = JT.prefill_chunk_init(JCFG, js, 48, 48)
    tsts = {b: T.prefill_chunk_init(TCFG, ts, 48, 48, device="cpu")
            for b in ("reference", "cuda")}
    assert sorted(tsts["cuda"]["caches"]["scan"]) == sorted(
        jst["caches"]["scan"])
    pos = 0
    while pos < len(prompt):
        n = min(16, len(prompt) - pos)
        bucket = 8 if n <= 8 else 16
        tk = np.zeros((1, bucket), np.int32)
        tk[0, :n] = prompt[pos:pos + n]
        lj, jst = fn(jst, jnp.asarray(tk), jnp.int32(pos), jnp.int32(n))
        for b, st in tsts.items():
            lt, _ = T.prefill_chunk(tp, TCFG, torch.from_numpy(tk).long(), st,
                                    ts, pos, n, backend=b)
            np.testing.assert_allclose(t2n(lt), np.asarray(lj),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"{b} chunk at {pos}")
        pos += n
    for st in tsts.values():
        _compare_band_caches(st["caches"]["scan"], jst["caches"]["scan"])


# ------------------------------------------------------------ the fp16 route

def test_fp16_decode_fallback_equals_jax(rng):
    """The fp16 branch of ``cuda_decode_attention`` on the CPU against
    ``pallas_decode_attention`` on an fp16 policy: dense per-slot masks,
    GQA, a local window."""
    b, s, hkv, gq, d = 3, 40, 2, 2, 32
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    q = rng.normal(size=(b, 1, hkv * gq, d)).astype(np.float32)
    lens = np.asarray([1, 17, 40], np.int32)
    jpol16 = jpol.FP16_POLICY
    for window in (None, 8):
        want = jops.pallas_decode_attention(
            jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                             "length": jnp.asarray(lens)}, jpol16,
            scale=d ** -0.5, window=window, dtype=jnp.float32)
        before = ops.FP16_CALLS["attend"]
        got = ops.cuda_decode_attention(
            torch.from_numpy(q), {"k": torch.from_numpy(k),
                                  "v": torch.from_numpy(v),
                                  "length": torch.from_numpy(lens)},
            FP16_POLICY, scale=d ** -0.5, window=window, dtype=torch.float32)
        assert ops.FP16_CALLS["attend"] == before + 1
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=FP_TOL,
                                   rtol=FP_TOL)


def test_fp16_chunk_write_equals_token_loop_and_jax(rng):
    """The fp16 chunk append writes in bulk what the token loop of
    ``decode_append`` writes (bitwise) and what the reference's chunk
    append writes, with per-slot ``n_valid`` and padded buckets."""
    pol = FP16_POLICY
    tc = kvc.init_cache(2, 40, 2, 32, pol, torch.float32, device="cpu")
    loop = {k: v.clone() for k, v in tc.items()}
    jc = jkvc.init_cache(2, 40, 2, 32, jpol.FP16_POLICY, jnp.float32)
    for n in (3, 9, 16, 5):
        c = 16
        k = rng.normal(size=(2, c, 2, 32)).astype(np.float32)
        v = rng.normal(size=(2, c, 2, 32)).astype(np.float32)
        nv = np.asarray([n, max(n - 2, 0)], np.int32)
        kt, vt, nvt = (torch.from_numpy(a) for a in (k, v, nv))
        kvc.prefill_chunk_append(tc, kt, vt, pol, nvt)
        for i in range(c):
            kvc.decode_append(loop, kt[:, i:i + 1], vt[:, i:i + 1], pol,
                              valid=torch.as_tensor(i < nvt))
        jc = jkvc.prefill_chunk_append(jc, jnp.asarray(k), jnp.asarray(v),
                                       jpol.FP16_POLICY, jnp.asarray(nv))
        for key in tc:
            assert torch.equal(tc[key], loop[key]), (key, n)
            np.testing.assert_array_equal(t2n(tc[key]), np.asarray(jc[key]))


def test_cuda_backend_routes_by_policy():
    """The route is the policy's, chosen statically: fp16 bands get the
    fp16 writes and no quantizer, quantized bands the kernels; neither
    route takes the other's policy."""
    be = bk.get_backend("cuda")
    g = fp16_guard(PAPER_POLICY)
    assert be.append_fn(g) is ops.fp16_append
    assert be.chunk_append_fn(g) is ops.fp16_chunk_append
    assert be.quant_fn(g) is None
    assert be.append_fn(PAPER_POLICY) is KQ.kv_append
    assert be.chunk_append_fn(PAPER_POLICY) is KQ.kv_append_chunk
    assert be.quant_fn(PAPER_POLICY) is not None
    cache = kvc.init_cache(1, 40, 2, 32, PAPER_POLICY, torch.float32,
                           device="cpu")
    x = torch.zeros((1, 1, 2, 32))
    with pytest.raises(ValueError, match="fp16 route"):
        ops.fp16_append(cache, x, x, PAPER_POLICY)
    with pytest.raises(ValueError, match="fp16 route"):
        ops.fp16_chunk_append(cache, x, x, PAPER_POLICY, 0, 1)
    fp = kvc.init_cache(1, 40, 2, 32, g, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="fp16"):
        KQ.append_launch_args(fp, x, x, g)


# ------------------------------------------------------------------ Engine

def _traffic():
    r = np.random.default_rng(7)
    return [(r.integers(0, 64, n).astype(np.int32), m)
            for n, m in zip((20, 9, 26), (6, 4, 5))]


def _jax_streams(jp, sched, traffic, **kw):
    eng = JEngine(jp, JCFG, sched, batch_slots=2, max_len=52,
                  backend="reference", steps_per_sync=4, **kw)
    hs = [eng.submit(JRequest(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    return [h.tokens for h in hs]


def _port_engine(tp, sched, backend="reference", **kw):
    return Engine(tp, TCFG, sched, batch_slots=2, max_len=52,
                  backend=backend, steps_per_sync=4, pool_block_tokens=8,
                  device="cpu", **kw)


def _port_streams(eng, traffic):
    hs = [eng.submit(Request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert eng.active_slots == 0
    return [h.tokens for h in hs]


@pytest.mark.parametrize("name", ["guard", "ladder"])
def test_scheduled_engine_streams_equal_jax(params, name):
    """Greedy streams of the scheduled Engine, both backends, whole-prompt
    and chunked, equal the JAX Engine's under the same schedule; the fp16
    route ran exactly on the guard layers."""
    jp, tp = params
    js, ts = _scheds(name)
    traffic = _traffic()
    want = _jax_streams(jp, js, traffic)
    assert [len(s) for s in want] == [m for _, m in traffic]
    n_fp16 = sum(p.is_fp16 for p in ts)
    for backend in ("reference", "cuda"):
        eng = _port_engine(tp, ts, backend)
        reset_launch_counts()
        assert _port_streams(eng, traffic) == want, backend
        c = launch_counts()
        if backend == "cuda":
            assert c["fp16"]["attend"] == c["fp16"]["append"] \
                == n_fp16 * eng.n_decode_steps
            assert c["decode_attn"]["plain"] == (4 - n_fp16) \
                * eng.n_decode_steps
    chunked = _jax_streams(jp, js, traffic, prefill_chunk=8)
    eng = _port_engine(tp, ts, "cuda", prefill_chunk=8)
    assert _port_streams(eng, traffic) == chunked


@pytest.mark.parametrize("name", ["guard", "ladder"])
def test_pooled_scheduled_streams_equal_striped(params, name):
    """One pool per quantized band, every band the same block count, fp16
    bands striped; pooled streams (whole-prompt and chunked) equal the
    striped ones; stats and the audit report per band."""
    _, tp = params
    _, ts = _scheds(name)
    traffic = _traffic()
    want = _port_streams(_port_engine(tp, ts, "cuda"), traffic)
    quant = [(bs, be) for bs, be, p in ts.bands() if not p.is_fp16]
    for chunk in (None, 8):
        eng = _port_engine(tp, ts, "cuda", pool_blocks=24,
                           prefill_chunk=chunk)
        assert sorted(eng._pools) == [("scan", f"L{bs:03d}")
                                      for bs, _ in quant]
        assert all(p.n_blocks == 24 for p in eng._pools.values())
        assert _port_streams(eng, traffic) == want, chunk
        audit = eng.check_invariants()
        assert sorted(audit) == [f"scan/L{bs:03d}" for bs, _ in quant]
        st = eng.stats()
        assert sorted(st["bands"]) == sorted(audit)
        assert st["used"] == 0 and st["prefix_misses"] > 0
        for bs, be, p in ts.bands():
            band = eng._caches["scan"][f"L{bs:03d}"]
            assert ("block_tbl" in band) == (not p.is_fp16)
        info = eng.backend_info
        assert info["pool_bytes"] == sum(24 * v for v in
                                         info["pool_bands"].values())


def test_pool_capacity_error_names_the_band(params):
    _, tp = params
    _, ts = _scheds("guard")
    eng = _port_engine(tp, ts, pool_blocks=2)
    with pytest.raises(ValueError, match=r"in band L001 \(scan\)"):
        eng.submit(Request(prompt=np.zeros(40, np.int32), max_new=4))
    fp = PolicySchedule.uniform(fp16_guard(QuantPolicy(**KW)), 4)
    with pytest.raises(ValueError, match="no packed region"):
        _port_engine(tp, fp, pool_blocks=8)
    with pytest.raises(ValueError, match="band L001 packed capacity"):
        Engine(tp, TCFG, ts, batch_slots=1, max_len=50, pool_blocks=8,
               pool_block_tokens=8, device="cpu")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_uniform_schedule_is_bitwise_the_bare_policy(params, rng, backend):
    """A uniform schedule runs the bare policy's program: the same flat
    cache structure and every leaf, prefill and decode logits, and Engine
    streams striped, pooled and warmed, all bitwise."""
    _, tp = params
    pol = QuantPolicy(**KW)
    uni = PolicySchedule.uniform(pol, 4)
    toks = torch.as_tensor(rng.integers(0, 64, (2, 30)))
    l0, c0 = T.prefill_model(tp, TCFG, toks, pol, max_len=48, backend=backend)
    l1, c1 = T.prefill_model(tp, TCFG, toks, uni, max_len=48, backend=backend)
    assert torch.equal(l0, l1) and sorted(c0["scan"]) == sorted(c1["scan"])
    assert "length" in c1["scan"]                      # flat, not band-keyed
    tok = l0[:, -1].argmax(-1, keepdim=True)
    d0, c0 = T.decode_step(tp, TCFG, tok, c0, pol, backend=backend)
    d1, c1 = T.decode_step(tp, TCFG, tok, c1, as_schedule(pol, 4),
                           backend=backend)
    assert torch.equal(d0, d1)
    for k in c0["scan"]:
        assert torch.equal(c0["scan"][k], c1["scan"][k]), k
    traffic = _traffic()
    for kw in ({}, {"pool_blocks": 24}):
        runs = []
        for p in (pol, uni):
            eng = _port_engine(tp, p, backend, **kw)
            if kw:
                eng.warmup()
            runs.append(_port_streams(eng, traffic))
        assert runs[0] == runs[1], kw
    eng = _port_engine(tp, uni)
    assert eng.policy is uni and eng.schedule is uni
    assert _port_engine(tp, pol).policy is pol


def test_warmed_scheduled_engine_and_backend_info(params):
    """warmup() on a banded engine (fp16 and kernel bands in one step):
    no graph miss, fresh band-keyed caches, streams equal the unwarmed
    engine's; backend_info carries the schedule's accounting."""
    _, tp = params
    _, ts = _scheds("guard")
    traffic = _traffic()
    cold = _port_streams(_port_engine(tp, ts, "cuda", pool_blocks=24),
                         traffic)
    eng = _port_engine(tp, PolicySchedule.first_last_fp16(QuantPolicy(**KW),
                                                          1),
                       "cuda", pool_blocks=24, async_host=True)
    assert eng.schedule == ts
    rep = eng.warmup()
    assert rep["post_warmup_misses"] == 0
    assert all(int(v.abs().sum()) == 0 for band in
               eng._caches["scan"].values() for k, v in band.items()
               if k != "block_tbl")
    assert _port_streams(eng, traffic) == cold
    assert eng.warmup_report()["post_warmup_misses"] == 0
    eng.close()
    info = eng.backend_info
    assert info["n_policies"] == 2 and not info["schedule_uniform"]
    assert info["layer_avg_bits"][0] == 16.0
    assert info["avg_bits"] == pytest.approx(sum(info["layer_avg_bits"]) / 4)
    assert info["layer_cache_bytes"] == kvc.schedule_cache_nbytes(
        ts, 4, 52, 2, 32, torch.float32)
    assert info["cache_bytes_per_slot"] == sum(info["layer_cache_bytes"])


def test_scheduled_entry_points_raise_without_cuda_unless_cpu(params):
    """Scheduled entry points default to the card like every other one:
    without a card they raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tp = params
    _, ts = _scheds("guard")
    for call in (lambda **kw: Engine(tp, TCFG, ts, batch_slots=1, max_len=52,
                                     pool_blocks=8, pool_block_tokens=8,
                                     **kw),
                 lambda **kw: T.prefill_chunk_init(TCFG, ts, 40, 40, **kw),
                 lambda **kw: T.identity_calib(TCFG, ts[0], **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "llama2_7b", "--smoke", "--policy-schedule",
                     "ladder"])


# --------------------------------------------------------------------- CLI

TABLE = re.compile(r"^  (?:layers|\d+(?:-\d+)? |schedule ).*$", re.M)


@pytest.mark.parametrize("preset,extra", [
    ("first_last_fp16", ["--guard-layers", "1"]),
    ("ladder", ["--prefill-chunk", "16", "--pool-blocks", "24",
                "--pool-block-tokens", "8"])])
def test_cli_schedules(capsys, preset, extra):
    """``--policy-schedule`` on the smoke arch with ``--device cpu``: the
    clamp note for a 2-layer arch, and the printed table equal to the
    reference CLI's table for the same schedule."""
    args = ["--arch", "llama3p2_1b", "--smoke", "--batch", "2",
            "--requests", "3", "--prompt-len", "40", "--new-tokens", "4",
            "--steps-per-sync", "2", "--policy-schedule", preset] + extra
    handles = tserve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert all(h.finished for h in handles)
    assert f"schedule={preset}" in out
    jcfg = jconfigs.get_smoke("llama3p2_1b")
    jp = jpol.QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=32,
                          n_sink=5)
    if preset == "first_last_fp16":
        assert ("note: --guard-layers 1 clamped to 0 (2-layer arch needs "
                "2*guard < layers)") in out
        js = jpol.PolicySchedule.first_last_fp16(jp, 0, 2)
        max_len = 40 + 4 + 2
    else:
        assert "pool:" in out and "chunked prefill:" in out
        js = jpol.PolicySchedule.bits_ladder(jp, ((4.0, 4.0), (2.0, 1.5),
                                                  (2.0, 1.5)), 2)
        max_len = 40 + 4 + 2
        while (max_len - 5 - 32) % 8:
            max_len += 1
    jserve._print_schedule_table(js, jcfg, max_len, jnp.float32)
    want = TABLE.findall(capsys.readouterr().out)
    assert want and TABLE.findall(out) == want


# --------------------------------------------------------------- granite_8b

def test_granite_8b_smoke_equals_jax(rng):
    """granite_8b (GQA 4:2 at smoke size, rope theta 1e7, tied embeddings)
    is in the registry with the reference's shapes; its SMOKE prefill and
    decode logits equal the JAX package's."""
    cfg, jcfg = configs.get("granite-8b"), jconfigs.get("granite_8b")
    assert cfg == ArchConfig(**{f: getattr(jcfg, f) for f in
                                ArchConfig.__dataclass_fields__})
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta,
            cfg.tie_embeddings) == (36, 4096, 32, 8, 128, 14336, 49152,
                                    1e7, True)
    scfg, sjcfg = configs.get_smoke("granite_8b"), jconfigs.get_smoke(
        "granite_8b")
    jp = JT.init_params(sjcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), scfg, device="cpu")
    jpo, tpo = jpol.QuantPolicy(**KW), QuantPolicy(**KW)
    toks = rng.integers(0, scfg.vocab_size, (2, 24)).astype(np.int32)
    for tb, jb in BACKENDS:
        lj, cj = jax.jit(lambda p, t: JT.prefill_model(
            p, sjcfg, {"tokens": t}, jpo, max_len=40, backend=jb))(
            jp, jnp.asarray(toks))
        lt, ct = T.prefill_model(tp, scfg, torch.from_numpy(toks).long(), tpo,
                                 max_len=40, backend=tb)
        np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        tok = np.asarray(lj[:, -1].argmax(-1))[:, None].astype(np.int32)
        lj, _ = jax.jit(lambda p, t, c: JT.decode_step(
            p, sjcfg, t, c, jpo, backend=jb))(jp, jnp.asarray(tok), cj)
        lt, _ = T.decode_step(tp, scfg, torch.from_numpy(tok).long(), ct, tpo,
                              backend=tb)
        np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
