"""The port's chunked prefill (DESIGN.md §7) against the JAX package on the
same numpy inputs: ``chunk_segment``, ``prefill_chunk_attention``,
``prefill_chunk_append``, the chunk append's bulk route
``kernels.kv_quant.kv_append_chunk``, ``transformer.prefill_chunk`` and the
chunked ``Engine``, striped and pooled.

Tolerances, and why:
* positions, masks, every cache byte of the module-level appends, and
  greedy tokens: EXACT (the same f32 inputs go through the same per-token
  quantization on both sides);
* ``prefill_chunk_attention``: f32 ``atol = rtol = 1e-5`` on valid rows
  (torch and XLA sum the same products in other orders); the port's
  frontier cut against its own uncut loop: BITWISE;
* ``prefill_chunk`` (model level, smoke shapes, non-identity calibration):
  logits ``atol = rtol = 2e-4`` and at most 0.5% of packed bytes flipped,
  fp sink/window values ``1e-5``, lengths exact — the bounds of
  tests/test_torch_model.py, for the same reasons (matmul order moves K/V
  in the last bit, which can flip a code at a rounding edge).
The card-only cases live in tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import kv_cache as jkvc
from repro.core import segments as jseg
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import n_meta_groups
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import default_chunk_buckets as j_buckets

from repro_torch import configs
from repro_torch.convert import calib_from_numpy, params_from_numpy
from repro_torch.core import kv_cache as kvc
from repro_torch.core import segments as seg
from repro_torch.core.block_pool import prefix_block_keys
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import quantize_groups
from repro_torch.kernels import kv_quant as KQ
from repro_torch.models import attention as TA
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serving import Engine, Request, default_chunk_buckets
from test_torch_util import assert_tree_exact, t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
ATTN_TOL = 1e-5
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3
SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=64)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
# (window, n_sink) variants of the append tests: the paper's layout, no
# sinks, and the no-window ablation
LAYOUTS = [(8, 4), (8, 0), (0, 4)]


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _pols(window, n_sink):
    kw = dict(KW, window=window, n_sink=n_sink)
    return JPolicy(**kw), QuantPolicy(**kw)


# ------------------------------------------------------------ chunk_segment

@pytest.mark.parametrize("t0,n_valid,size", [(0, 8, 8), (5, 3, 8),
                                             (37, 16, 16), (12, 0, 4)])
def test_chunk_segment_equals_jax_scalar(t0, n_valid, size):
    pos, valid = seg.chunk_segment(t0, n_valid, size)
    jpos, jvalid = jseg.chunk_segment(t0, n_valid, size)
    assert pos.shape == (size,) and pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_chunk_segment_equals_jax_per_slot():
    t0, nv = np.asarray([0, 9, 30], np.int32), np.asarray([8, 2, 5], np.int32)
    for a, b in ((t0, nv), (t0, 4), (7, nv)):
        pos, valid = seg.chunk_segment(torch.as_tensor(a), torch.as_tensor(b),
                                       8)
        jpos, jvalid = jseg.chunk_segment(a, b, 8)
        assert tuple(pos.shape) == (3, 8)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


# -------------------------------------------------- prefill_chunk_attention

def _ws_inputs(rng, cap, c, t0, n_valid, dirty=True):
    """q (1, C, 4, 32) and a workspace (1, cap, 2, 32) whose rows at or past
    the frontier hold stale values (a recycled workspace)."""
    q = rng.normal(size=(1, c, 4, 32)).astype(np.float32)
    ws = [rng.normal(size=(1, cap, 2, 32)).astype(np.float32)
          for _ in range(2)]
    if dirty:
        for w in ws:
            w[:, t0 + n_valid:] *= 50.0
    return q, ws[0], ws[1]


@pytest.mark.parametrize("t0,n_valid,c,window", [
    (0, 8, 8, None), (40, 16, 16, None), (120, 13, 16, None),
    (200, 16, 16, 24)])
def test_prefill_chunk_attention_equals_jax(rng, t0, n_valid, c, window):
    q, wk, wv = _ws_inputs(rng, 300, c, t0, n_valid)
    jpos, _ = jseg.chunk_segment(t0, n_valid, c)
    want = JA.prefill_chunk_attention(jnp.asarray(q), jnp.asarray(wk),
                                      jnp.asarray(wv), jpos, JCFG,
                                      window=window)
    pos, _ = seg.chunk_segment(t0, n_valid, c)
    got = TA.prefill_chunk_attention(torch.from_numpy(q),
                                     torch.from_numpy(wk),
                                     torch.from_numpy(wv), pos, TCFG,
                                     window=window,
                                     frontier=t0 + n_valid)
    np.testing.assert_allclose(t2n(got)[:, :n_valid],
                               np.asarray(want)[:, :n_valid],
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("t0,n_valid,c,window", [
    (0, 5, 8, None), (120, 8, 8, None), (128, 16, 16, None),
    (250, 16, 16, None), (300, 9, 16, 40)])
def test_frontier_cut_is_bitwise_the_uncut_loop(rng, t0, n_valid, c,
                                                window):
    """Cutting the key loop at the frontier's block changes no bit of a
    valid row, whatever the stale rows past the frontier hold."""
    q, wk, wv = (torch.from_numpy(a) for a in
                 _ws_inputs(rng, 517, c, t0, n_valid))
    pos, _ = seg.chunk_segment(t0, n_valid, c)
    cut = TA.prefill_chunk_attention(q, wk, wv, pos, TCFG, window=window,
                                     frontier=t0 + n_valid)
    full = TA.prefill_chunk_attention(q, wk, wv, pos, TCFG, window=window)
    assert torch.equal(cut[:, :n_valid], full[:, :n_valid])


# ---------------------------------------------------- prefill_chunk_append

# (t0 of the cache, chunk sizes, bucket) sequences: chunks that straddle
# the sink boundary, shorter and longer than the window, padded buckets
CHUNKINGS = [(0, [3, 2, 8, 20, 5, 16, 6], 16), (0, [1, 1, 1, 1, 1, 1, 8], 8),
             (0, [16, 16, 16, 12], 16), (0, [7, 30, 23], 32)]
MAX_LEN = 60


def _chunks(rng, sizes, bucket, b=1, h=2, d=32):
    out = []
    for n in sizes:
        c = max(bucket, n)
        out.append((n, rng.normal(size=(b, c, h, d)).astype(np.float32),
                    rng.normal(size=(b, c, h, d)).astype(np.float32)))
    return out


def _alphas(rng, h=2, d=32):
    return [rng.uniform(0.8, 1.0, (h, n_meta_groups(d, bits, 16))).astype(
        np.float32) for bits in (KW["bits_k"], KW["bits_v"])]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("chunking", CHUNKINGS[:2] + CHUNKINGS[3:])
def test_prefill_chunk_append_equals_jax(rng, layout, chunking):
    jpol, tpol = _pols(*layout)
    _, sizes, bucket = chunking
    ak, av = _alphas(rng)
    jc = jkvc.init_cache(2, MAX_LEN, 2, 32, jpol, jnp.float32)
    tc = kvc.init_cache(2, MAX_LEN, 2, 32, tpol, torch.float32, device="cpu")
    append = jax.jit(lambda c, k, v, nv: jkvc.prefill_chunk_append(
        c, k, v, jpol, nv, jnp.asarray(ak), jnp.asarray(av)))
    for n, k, v in _chunks(rng, sizes, bucket, b=2):
        nv = np.asarray([n, max(n - 1, 0)], np.int32)    # per-slot n_valid
        jc = append(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(nv))
        kvc.prefill_chunk_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                                 tpol, torch.from_numpy(nv),
                                 torch.from_numpy(ak), torch.from_numpy(av))
        assert_tree_exact(tc, jc, f"chunk of {n}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("chunking", CHUNKINGS)
def test_kv_append_chunk_route_equals_token_loop(rng, layout, chunking):
    """The bulk route (plain quantizer passed in) leaves every leaf
    byte-equal to the token loop after every chunk; a chunk that evicts
    nothing quantizes nothing, one that does quantizes K and V once."""
    _, tpol = _pols(*layout)
    _, sizes, bucket = chunking
    ak, av = (torch.from_numpy(a) for a in _alphas(rng))
    loop = kvc.init_cache(1, MAX_LEN, 2, 32, tpol, torch.float32,
                          device="cpu")
    route = {k: v.clone() for k, v in loop.items()}
    calls = []

    def counted(x, *args):
        calls.append(x.shape[1])
        return quantize_groups(x, *args)
    t0 = 0
    for n, k, v in _chunks(rng, sizes, bucket):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
        KQ.kv_append_chunk_plain(loop, k, v, tpol, t0, n, ak, av)
        before = len(calls)
        KQ.kv_append_chunk(route, k, v, tpol, t0, n, ak, av,
                           quant_fn=counted)
        for key in loop:
            assert torch.equal(loop[key], route[key]), (key, t0, n)
        lo, hi = KQ.chunk_evictions(tpol, t0, n)
        ends_in_sinks = tpol.window == 0 and t0 + n <= tpol.n_sink
        assert len(calls) - before == (2 if lo < hi or ends_in_sinks else 0)
        if lo < hi:
            assert calls[-1] == hi - lo
        t0 += n
    assert int(route["length"]) == sum(sizes)


def test_kv_append_chunk_refuses_what_it_cannot_take():
    _, tpol = _pols(8, 4)
    cache = kvc.init_cache(1, 40, 2, 32, tpol, torch.float32, device="cpu")
    k = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="do not fit"):
        KQ.kv_append_chunk(cache, k, k, tpol, 36, 8, quant_fn=quantize_groups)
    two = kvc.init_cache(2, 40, 2, 32, tpol, torch.float32, device="cpu")
    with pytest.raises(ValueError, match=r"\(1, C, H, D\)"):
        KQ.kv_append_chunk(two, k.expand(2, -1, -1, -1),
                           k.expand(2, -1, -1, -1), tpol, 0, 8,
                           quant_fn=quantize_groups)
    pooled = kvc.init_pooled_cache(1, 44, 2, 32, tpol, 8, 8, torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="striped"):
        KQ.kv_append_chunk(pooled, k, k, tpol, 0, 8, quant_fn=quantize_groups)
    fp16 = QuantPolicy(bits_k=16, bits_v=16, window=0, n_sink=0)
    with pytest.raises(NotImplementedError, match="fp16"):
        KQ.kv_append_chunk(cache, k, k, fp16, 0, 8, quant_fn=quantize_groups)


def test_kv_append_chunk_on_the_cpu_is_the_token_loop(rng):
    _, tpol = _pols(8, 4)
    cache = kvc.init_cache(1, 40, 2, 32, tpol, torch.float32, device="cpu")
    k = torch.from_numpy(rng.normal(size=(1, 16, 2, 32)).astype(np.float32))
    before = dict(KQ.LAUNCHES)
    KQ.kv_append_chunk(cache, k, k, tpol, 0, 16)
    assert KQ.LAUNCHES["chunk_plain"] == before["chunk_plain"] + 1
    assert KQ.LAUNCHES["kernel"] == before["kernel"]


# ---------------------------------------------------------- prefill_chunk

def _model_setup(arch, rng):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    n, h, d = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    perm = lambda: np.stack([np.stack([rng.permutation(d) for _ in range(h)])
                             for _ in range(n)]).astype(np.int32)
    gk = n_meta_groups(d, KW["bits_k"], min(KW["group_size"], d))
    gv = n_meta_groups(d, KW["bits_v"], min(KW["group_size"], d))
    cal = {"perm_k": perm(), "perm_v": perm(),
           "alpha_k": rng.uniform(0.8, 1.0, (n, h, gk)).astype(np.float32),
           "alpha_v": rng.uniform(0.8, 1.0, (n, h, gv)).astype(np.float32)}
    return (jcfg, tcfg, jp, tp, {k: jnp.asarray(v) for k, v in cal.items()},
            calib_from_numpy(cal, device="cpu"))


def _compare_caches(ct, cj):
    for k, want in jax.tree.map(np.asarray, cj["scan"]).items():
        got = ct["scan"][k].numpy()
        if k == "length":
            np.testing.assert_array_equal(got, want)
        elif k.startswith(("sink_", "win_")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            rate = float(np.mean(got != want))
            assert rate <= FLIP_RATE, (k, rate)


@pytest.mark.parametrize("tb,jb", [("reference", "reference"),
                                   ("cuda", "pallas")])
def test_prefill_chunk_equals_jax(rng, tb, jb):
    """A 45-token prompt in chunks of 16 (buckets 8/16: the tail of 13 runs
    padded to 16) through both models: logits of every chunk's last valid
    row and the grown caches."""
    jcfg, tcfg, jp, tp, jcal, tcal = _model_setup("llama3p2_1b", rng)
    prompt = rng.integers(0, jcfg.vocab_size, 45).astype(np.int32)
    max_len = 64
    js = JT.prefill_chunk_init(jcfg, JPolicy(**KW), max_len, max_len)
    ts = T.prefill_chunk_init(tcfg, QuantPolicy(**KW), max_len, max_len,
                              device="cpu")
    fn = jax.jit(lambda p, tk, st, a, b: JT.prefill_chunk(
        p, jcfg, tk, st, JPolicy(**KW), a, b, calib=jcal, backend=jb))
    pos = 0
    while pos < len(prompt):
        n = min(16, len(prompt) - pos)
        bucket = 8 if n <= 8 else 16
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt[pos:pos + n]
        lj, js = fn(jp, jnp.asarray(toks), js, jnp.int32(pos), jnp.int32(n))
        lt, ts = T.prefill_chunk(tp, tcfg, torch.from_numpy(toks), ts,
                                 QuantPolicy(**KW), pos, n, calib=tcal,
                                 backend=tb)
        assert tuple(lt.shape) == (1, 1, jcfg.vocab_size)
        np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"chunk at {pos}")
        pos += n
    _compare_caches(ts["caches"], js["caches"])


def test_prefill_chunk_init_and_checks():
    pol = QuantPolicy(**KW)
    st = T.prefill_chunk_init(TCFG, pol, 40, 48, dtype=torch.bfloat16,
                              device="cpu")
    assert tuple(st["ws"]["scan"]["k"].shape) == (2, 1, 48, 2, 32)
    assert st["ws"]["scan"]["v"].dtype == torch.bfloat16
    shapes = kvc.cache_shapes(1, 40, 2, 32, pol, torch.bfloat16)
    assert {k: tuple(v.shape[1:]) for k, v in st["caches"]["scan"].items()} \
        == {k: s for k, (s, _) in shapes.items()}
    with pytest.raises(ValueError, match="cap"):
        T.prefill_chunk_init(TCFG, pol, 40, 39, device="cpu")
    moe = dataclasses.replace(TCFG, family="moe")
    with pytest.raises(NotImplementedError, match="dense"):
        T.prefill_chunk_init(moe, pol, 40, 40, device="cpu")


# ------------------------------------------------------------------ Engine

def _traffic():
    r = np.random.default_rng(7)
    lens, news = [31, 9, 23, 17, 5, 13], [5, 2, 7, 4, 6, 3]
    return [(r.integers(0, 64, n).astype(np.int32), m)
            for n, m in zip(lens, news)]


def _run_jax(jp, traffic, pool=None):
    eng = JEngine(jp, JCFG, JPolicy(**KW), batch_slots=2, max_len=52,
                  backend="reference", steps_per_sync=4, prefill_chunk=8,
                  pool_blocks=pool, pool_block_tokens=8)
    hs = [eng.submit(JRequest(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    return [h.tokens for h in hs]


def _port_engine(tp, backend="reference", pool=None, **kw):
    return Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=kw.pop("slots", 2),
                  max_len=kw.pop("max_len", 52), backend=backend,
                  steps_per_sync=kw.pop("sps", 4),
                  prefill_chunk=kw.pop("chunk", 8), pool_blocks=pool,
                  pool_block_tokens=8, device="cpu", **kw)


def _run_port(tp, traffic, backend, pool=None):
    eng = _port_engine(tp, backend, pool)
    hs = [eng.submit(Request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert eng.active_slots == 0 and eng._prefill_job is None
    assert set(eng.prefill_shapes) <= set(eng.chunk_buckets)
    if pool:
        eng.check_invariants()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("pool", [None, 24], ids=["striped", "pooled"])
def test_chunked_engine_streams_equal_jax(params, pool):
    """Ragged two-wave traffic (the long prompt first, so later prompts
    prefill through a recycled dirty workspace): the port's chunked Engine
    on both backends gives the JAX chunked Engine's greedy streams."""
    jp, tp = params
    traffic = _traffic()
    want = _run_jax(jp, traffic, pool)
    assert [len(s) for s in want] == [m for _, m in traffic]
    for backend in ("reference", "cuda"):
        assert _run_port(tp, traffic, backend, pool) == want, backend


def test_default_chunk_buckets_ladder():
    for c in (64, 512, 8, 4, 12, 1):
        assert default_chunk_buckets(c) == j_buckets(c)
    assert default_chunk_buckets(64) == (8, 16, 32, 64)
    assert default_chunk_buckets(4) == (4,)


def test_prefill_does_not_stall_decode(params):
    _, tp = params
    r = np.random.default_rng(1)
    eng = _port_engine(tp, max_len=128, sps=2)
    active = eng.submit(Request(prompt=r.integers(0, 64, 6), max_new=40))
    eng.step()
    eng.step()                                  # admitted, first decode chunk
    assert len(active.tokens) > 0
    long_h = eng.submit(Request(prompt=r.integers(0, 64, 80), max_new=4))
    ticks = 0
    while long_h.first_token_time is None:
        before = len(active.tokens)
        eng.step()                              # one prefill chunk + decode
        ticks += 1
        assert active.finished or len(active.tokens) > before, \
            "decode lane starved during chunked prefill"
    assert ticks >= 80 // 8
    eng.run()
    assert long_h.finished and active.finished


def test_prefill_job_reserves_slot_without_decoding_it(params):
    _, tp = params
    eng = _port_engine(tp, slots=1, max_len=64, sps=2)
    h = eng.submit(Request(prompt=np.arange(20) % 64, max_new=3))
    eng.step()                                  # chunk 1 of 3: no tokens
    assert len(h.tokens) == 0 and h.first_token_time is None
    assert eng._prefill_job is not None and eng.active_slots == 0
    eng.run([h])
    assert h.finished and len(h.tokens) == 3


def test_engine_chunk_validation(params):
    _, tp = params
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port_engine(tp, chunk=0)
    with pytest.raises(ValueError, match="chunk_buckets"):
        _port_engine(tp, chunk=8, chunk_buckets=(4,))
    with pytest.raises(ValueError, match="chunk_buckets"):
        Engine(tp, TCFG, QuantPolicy(**KW), batch_slots=1, max_len=32,
               chunk_buckets=(8,), device="cpu")
    ssm = dataclasses.replace(TCFG, family="ssm")
    with pytest.raises(NotImplementedError, match="dense"):
        Engine(tp, ssm, QuantPolicy(**KW), batch_slots=1, max_len=32,
               prefill_chunk=8, device="cpu")
    eng = _port_engine(tp, chunk=16, chunk_buckets=(16, 4))
    assert eng.chunk_buckets == (4, 16)


def test_chunked_warmup_rehearses_every_bucket(params):
    """warmup() runs one throwaway chunk and one rehearsal prompt per
    bucket, then restores: streams afterwards equal an unwarmed engine's."""
    _, tp = params
    traffic = _traffic()[:3]
    eng = _port_engine(tp, chunk=16)
    rep = eng.warmup()
    assert rep["post_warmup_misses"] == 0
    assert eng.prefill_shapes == eng.chunk_buckets == (8, 16)
    assert eng.stats()["counters"]["admitted"] == 0
    hs = [eng.submit(Request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    cold = _port_engine(tp, chunk=16)
    hc = [cold.submit(Request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    cold.run(hc)
    assert [h.tokens for h in hs] == [h.tokens for h in hc]


def test_pooled_prefix_key_is_no_hit_before_its_owner_finishes(params):
    """A chunked job's miss keys are registered only at its last chunk:
    until then a lookup of its shared prefix finds nothing; afterwards the
    next request with that prefix takes a hit, and its stream equals the
    striped engine's."""
    _, tp = params
    r = np.random.default_rng(3)
    prefix = r.integers(0, 64, 24)
    a = np.concatenate([prefix, r.integers(0, 64, 9)])
    b = np.concatenate([prefix, r.integers(0, 64, 5)])
    pol = QuantPolicy(**KW)
    keys, _ = prefix_block_keys(prefix.tolist(), pol.n_sink, pol.window, 8,
                                seed=f"scan:L000:{pol}")
    assert keys                          # the prefix fills a packed block
    eng = _port_engine(tp, pool=24)
    ha = eng.submit(Request(prompt=a, max_new=12))   # outlives b's admission
    eng.step()                           # admitted; chunk 1 of 5
    assert eng._prefill_job is not None
    assert eng._pending_register[eng._prefill_job.slot]
    pool = eng._pools[("scan", "L000")]
    assert all(pool.lookup(k) is None for k in keys)
    while eng._prefill_job is not None:
        eng.step()
    assert all(pool.lookup(k) is not None for k in keys)
    assert not eng._pending_register
    hb = eng.submit(Request(prompt=b, max_new=4))
    eng.run([ha, hb])
    assert eng.stats()["prefix_hits"] >= len(keys)
    eng.check_invariants()
    striped = _port_engine(tp)
    hs = [striped.submit(Request(prompt=p, max_new=m))
          for p, m in ((a, 12), (b, 4))]
    striped.run(hs)
    assert [ha.tokens, hb.tokens] == [h.tokens for h in hs]
