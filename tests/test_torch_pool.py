"""The port's paged KV block pool (DESIGN.md §9) against the JAX package on
the same inputs: the block-table index math, ``prefix_block_keys``,
``BlockPool`` traces, the pooled cache ops, the pooled decode_attn plain
version (against ``decode_attn_pallas(block_table=...)`` in interpret mode)
and the pooled ``Engine``.

Tolerances: integer results (tables, refcounts, keys, packed bytes, greedy
tokens, hit/miss/CoW counts) are EXACT.  The pooled decode_attn plain
version is held to the Pallas kernel at f32 ``atol=3e-5, rtol=1e-4`` (the
two sum the same products in other orders), and BITWISE to the striped
plain version at the same tile over the gathered planes.  The card-only
kernel tests live in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import block_pool as jbp
from repro.core import kv_cache as jkvc
from repro.core import segments as jseg
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import quantize_groups as j_quantize
from repro.kernels.decode_attn import decode_attn_pallas
from repro.models.config import ArchConfig as JArch
from repro.models import transformer as JT
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import ServeSession as JSession

from repro_torch.convert import params_from_numpy
from repro_torch.core import block_pool as tbp
from repro_torch.core import kv_cache as kvc
from repro_torch.core import segments as seg
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, Request, ServeSession
from test_torch_util import assert_tree_exact, j2t, t2n
from test_torch_util import (  # noqa: F401
    jax_cache_ops, jax_compile_cache, one_torch_thread)

ATOL, RTOL = 3e-5, 1e-4
SHAPE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=64)
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=16, n_sink=4)
JCFG, TCFG = JArch(**SHAPE), ArchConfig(**SHAPE)
JPOL, TPOL = JPolicy(**KW), QuantPolicy(**KW)
BT = 8
MAX_LEN = 68          # packed = 68 - 4 - 16 = 48 tokens = 6 BT-blocks
NB = 6


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# --------------------------------------------------------- block index math

def test_block_index_math_equals_jax():
    assert seg.n_table_blocks(48, 8) == jseg.n_table_blocks(48, 8) == 6
    for bad in ((50, 8), (48, 0)):
        with pytest.raises(ValueError):
            seg.n_table_blocks(*bad)
    tbl = np.asarray([[3, 1, 4], [2, 0, 5]], np.int32)
    lb = np.asarray([2, 0], np.int32)
    assert (seg.physical_block(torch.from_numpy(tbl), torch.from_numpy(lb))
            .tolist() == np.asarray(jseg.physical_block(tbl, lb)).tolist()
            == [4, 2])
    u = np.asarray([0, 7, 8, 17, 47])
    for fn, jfn in ((seg.logical_block, jseg.logical_block),
                    (seg.block_offset, jseg.block_offset)):
        assert fn(torch.from_numpy(u), 8).tolist() == \
            np.asarray(jfn(u, 8)).tolist()
    for lo in range(-20, 60, 3):
        for span in (1, 4, 9, 16):
            assert (list(seg.blocks_spanned(lo, lo + span, 8, 6))
                    == list(jseg.blocks_spanned(lo, lo + span, 8, 6))), \
                (lo, span)


@pytest.mark.parametrize("n_sink,window,bt", [(4, 16, 8), (0, 0, 16),
                                              (5, 128, 16)])
def test_prefix_block_keys_equal_jax(n_sink, window, bt):
    rng = np.random.default_rng(n_sink + window)
    for plen in (1, n_sink + window, n_sink + window + bt,
                 n_sink + window + 3 * bt + 5, 300):
        prompt = rng.integers(0, 32000, plen).tolist()
        for s in ("", "scan:L000:pol"):
            assert (tbp.prefix_block_keys(prompt, n_sink, window, bt, s)
                    == jbp.prefix_block_keys(prompt, n_sink, window, bt, s))


def _pool_trace(mod):
    """One scripted life of a BlockPool; returns what it observed."""
    pool = mod.BlockPool(5, n_slots=3, n_table=4, block_nbytes=100)
    seen = []
    a = pool.alloc(0)
    pool.assign(0, 0, a)
    pool.register("k0", a)
    pool.ref(a)
    pool.assign(1, 0, a)
    pool.set_reservation(0, 2)
    seen.append(pool.ensure_writable(0, 0))          # shared -> copy
    seen.append(pool.ensure_writable(1, 0))          # exclusive -> None
    seen.append(pool.ensure_writable(0, 3))          # empty -> alloc
    seen.append((pool.lookup("k0"), pool.available(), pool.reserved()))
    b = pool.alloc(2)
    pool.assign(2, 1, b)
    pool.register("k1", b)
    seen.append(pool.check_invariants())
    pool.alloc(2)       # taken and never assigned: a deliberate leak
    with pytest.raises(RuntimeError):
        pool.check_invariants()
    with pytest.raises(RuntimeError):
        pool.alloc(1)   # exhausted
    seen.append(pool.tables.tolist())
    seen.append(pool.refs.tolist())
    seen.append(pool.stats())
    for s in range(3):
        pool.release_slot(s)
    seen.append((pool.used(), pool.lookup("k1"), pool.tables.tolist()))
    return seen


def test_block_pool_trace_equals_jax():
    got, want = _pool_trace(tbp), _pool_trace(jbp)
    assert got == want
    with pytest.raises(ValueError):
        tbp.BlockPool(5, 1, 2).ref(3)


# -------------------------------------------------- pooled cache primitives

def _dt(d):
    return str(d).replace("torch.", "")


def test_pooled_cache_shapes_and_block_bytes_equal_jax():
    for pol_kw in (KW, dict(KW, bits_k=4.0, bits_v=2.0, fp8_meta=False)):
        got = kvc.pooled_cache_shapes(3, MAX_LEN, 2, 16, QuantPolicy(**pol_kw),
                                      7, BT, torch.float32)
        want = jkvc.pooled_cache_shapes(3, MAX_LEN, 2, 16, JPolicy(**pol_kw),
                                        7, BT, jnp.float32)
        assert {k: (tuple(s), _dt(d)) for k, (s, d) in got.items()} == \
            {k: (tuple(s), jnp.dtype(d).name) for k, (s, d) in want.items()}
        assert (kvc.pool_block_nbytes(2, 16, QuantPolicy(**pol_kw), BT)
                == jkvc.pool_block_nbytes(2, 16, JPolicy(**pol_kw), BT))
    with pytest.raises(ValueError):
        kvc.pooled_cache_shapes(1, MAX_LEN + 1, 2, 16, TPOL, 7, BT)
    c = kvc.init_pooled_cache(3, MAX_LEN, 2, 16, TPOL, 7, BT, device="cpu")
    assert kvc.is_pooled(c) and kvc.slot_lengths(c).shape == (3,)


def _noise_pooled(rng, batch, pool_blocks, tbl):
    """A pooled cache with random planes/ring/sinks in both packages."""
    shapes = jkvc.pooled_cache_shapes(batch, MAX_LEN, 2, 16, JPOL,
                                      pool_blocks, BT, jnp.float32)
    c = {}
    for k, (s, d) in shapes.items():
        if jnp.dtype(d) == jnp.uint8:
            c[k] = rng.integers(0, 255, s).astype(np.uint8)
        elif jnp.dtype(d) == jnp.float32:
            c[k] = rng.normal(size=s).astype(np.float32)
        else:
            c[k] = np.zeros(s, np.int32)
    c["block_tbl"] = np.asarray(tbl, np.int32)
    return c


def _both(c):
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: torch.from_numpy(v.copy()) for k, v in c.items()})


def test_unpool_and_block_copies_equal_jax(rng):
    tbl = [[3, 1, 7, 2, 9, 5], [4, 8, 0, 0, 0, 0]]
    jc, tc = _both(_noise_pooled(rng, 2, 10, tbl))
    assert_tree_exact(kvc.unpool_cache(tc), jkvc.unpool_cache(jc), "unpool")
    pairs = np.asarray([[2, 5], [9, 1], [0, 0]], np.int32)
    jc = jkvc.pool_copy_block(jc, pairs)        # the port copies in place
    assert_tree_exact(kvc.pool_copy_block(tc, pairs), jc, "copy")
    src = {k: jnp.asarray(rng.integers(0, 255, s).astype(np.uint8))
           for k, (s, d) in jkvc.cache_shapes(
               2, MAX_LEN, 2, 16, JPOL, jnp.float32).items()
           if jkvc.is_plane_key(k)}
    ins = np.asarray([[1, 3], [5, 6], [0, 0]], np.int32)
    assert_tree_exact(
        kvc.pool_insert_blocks(tc, j2t(src), ins, src_slot=1),
        jkvc.pool_insert_blocks(jc, src, ins, src_slot=1), "insert")


def test_layer_stacked_insert_copy_equal_jax(rng):
    """pool_axis=1: the engine's (L, NP+1, BT, ...) leaves."""
    c = _noise_pooled(rng, 2, 8, [[1, 2, 0, 0, 0, 0], [3, 4, 5, 0, 0, 0]])
    st = {k: np.stack([v, v[::-1].copy() if k != "block_tbl" else v])
          for k, v in c.items()}
    jc, tc = _both(st)
    src = {k: rng.integers(0, 255, (2, 3) + tuple(s[1:])).astype(np.uint8)
           for k, (s, d) in jkvc.cache_shapes(
               3, MAX_LEN, 2, 16, JPOL, jnp.float32).items()
           if jkvc.is_plane_key(k)}
    js, ts = _both(src)
    ins = np.asarray([[0, 6], [4, 7]], np.int32)
    jc = jkvc.pool_insert_blocks(jc, js, ins, 2, pool_axis=1)
    assert_tree_exact(kvc.pool_insert_blocks(tc, ts, ins, 2, pool_axis=1), jc)
    cp = np.asarray([[6, 8], [0, 0]], np.int32)
    assert_tree_exact(kvc.pool_copy_block(tc, cp, pool_axis=1),
                      jkvc.pool_copy_block(jc, cp, pool_axis=1))


def test_table_aware_reset_insert_equal_jax(rng):
    c = _noise_pooled(rng, 3, 9, [[1, 2, 3, 0, 0, 0], [4, 5, 0, 0, 0, 0],
                                  [6, 7, 8, 9, 0, 0]])
    c["length"] = np.asarray([30, 28, 40], np.int32)
    st = {k: np.stack([v, v]) for k, v in c.items()}
    jc, tc = _both(st)
    want = jkvc.reset_slot({"scan": jc}, 1, batch_axis=1)
    got = kvc.reset_slot({"scan": tc}, 1, batch_axis=1)
    assert_tree_exact(got, want, "reset")
    assert (got["scan"]["qk_codes_hi"].numpy() == st["qk_codes_hi"]).all()
    src = {k: rng.normal(size=(2, 1) + tuple(s[1:])).astype(np.float32)
           if jnp.dtype(d) == jnp.float32 else
           np.full((2, 1) + tuple(s[1:]), 7, np.dtype(jnp.dtype(d).name))
           for k, (s, d) in jkvc.cache_shapes(
               3, MAX_LEN, 2, 16, JPOL, jnp.float32).items()}
    js, ts = _both(src)
    want = jkvc.insert_slot(want, 1, {"scan": js}, 0, batch_axis=1)
    got = kvc.insert_slot(got, 1, {"scan": ts}, 0, batch_axis=1)
    assert_tree_exact(got, want, "insert")
    assert int(got["scan"]["length"][0, 1]) == 7
    assert (got["scan"]["block_tbl"][:, 1] == 0).all()   # host pool's row


def test_pooled_decode_append_bytes_equal_jax(rng):
    """Appends through a scrambled table straddle blocks; the packed bytes
    equal the JAX pooled append and, gathered, the striped append."""
    b, h, d = 2, 2, 16
    tbl = np.asarray([[3, 1, 7, 2, 9, 5], [4, 8, 12, 6, 10, 11]], np.int32)
    start = KW["n_sink"] + KW["window"] + 2 * BT
    jp_ = jkvc.init_pooled_cache(b, MAX_LEN, h, d, JPOL, 12, BT, jnp.float32)
    jp_["block_tbl"] = jnp.asarray(tbl)
    jp_["length"] = jnp.asarray([start, start - 3], jnp.int32)
    tp_ = kvc.init_pooled_cache(b, MAX_LEN, h, d, TPOL, 12, BT,
                                torch.float32, device="cpu")
    tp_["block_tbl"].copy_(torch.from_numpy(tbl))
    tp_["length"].copy_(torch.tensor([start, start - 3]))
    ts_ = kvc.init_cache(b, MAX_LEN, h, d, TPOL, torch.float32, device="cpu")
    ts_["length"].copy_(tp_["length"])
    for t in range(2 * BT + 3):
        k = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        v = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        valid = np.asarray([True, t % 5 != 2])
        jp_ = jax_cache_ops().append(jp_, jnp.asarray(k), jnp.asarray(v),
                                     JPOL, valid=jnp.asarray(valid))
        for c in (tp_, ts_):
            kvc.decode_append(c, torch.from_numpy(k), torch.from_numpy(v),
                              TPOL, valid=torch.from_numpy(valid))
    # rows steered to the null block write garbage there; it is never read
    jp_ = dict(jp_)
    for key in jp_:
        if jkvc.is_plane_key(key):
            jp_[key] = jp_[key].at[0].set(0)
            tp_[key][0] = 0
    assert_tree_exact(tp_, jp_, "pooled append")
    striped = kvc.unpool_cache(tp_)
    for key in ts_:
        assert torch.equal(striped[key], ts_[key]), key


# ------------------------------------------------ pooled decode_attn (plain)

def _pooled_attn_case(rng, hkv, gq, d, bt, nb, live, fp8=True):
    pol_j = JPolicy(bits_k=2.0, bits_v=1.5, group_size=min(64, d), window=0,
                    n_sink=0, fp8_meta=fp8)
    pol_t = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=min(64, d),
                        window=0, n_sink=0, fp8_meta=fp8)
    b, n_phys = len(live), len(live) * nb + 1
    k = jnp.asarray(rng.normal(size=(n_phys, bt, hkv, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(n_phys, bt, hkv, d)), jnp.float32)
    k_qt = j_quantize(k, 2.0, min(64, d), fp8_meta=fp8)
    v_qt = j_quantize(v, 1.5, min(64, d), fp8_meta=fp8)
    perm = rng.permutation(np.arange(1, n_phys)).reshape(b, nb)
    tbl = perm.astype(np.int32)
    tbl[1, :2] = tbl[0, :2]                     # two slots share blocks
    s = nb * bt
    j = np.arange(s)
    mask = (j[None] < np.asarray(live)[:, None]).astype(np.float32)
    for i, n in enumerate(live):
        tbl[i, -(-n // bt):] = 0                # null past the frontier
    q = rng.normal(size=(b, hkv, gq, d)).astype(np.float32)
    return pol_j, pol_t, q, k_qt, v_qt, mask, tbl


@pytest.mark.parametrize("hkv,gq,d", [(2, 1, 64), (1, 4, 32)])
def test_pooled_plain_matches_pallas_interpret(hkv, gq, d, rng):
    bt, nb = 8, 6
    pol_j, pol_t, q, k_qt, v_qt, mask, tbl = _pooled_attn_case(
        rng, hkv, gq, d, bt, nb, [45, 20, 3])
    scale = d ** -0.5
    bounds = seg.packed_block_bounds(torch.from_numpy(mask) > 0, bt)
    want = decode_attn_pallas(jnp.asarray(q), k_qt, v_qt, jnp.asarray(mask),
                              pol_j, d, scale, interpret=True, block_s=bt,
                              block_bounds=jnp.asarray(bounds.numpy()),
                              block_table=jnp.asarray(tbl))
    got = DA.decode_attn(torch.from_numpy(q), j2t(k_qt), j2t(v_qt),
                         torch.from_numpy(mask), pol_t, d, scale,
                         block_s=bt, block_bounds=bounds,
                         block_table=torch.from_numpy(tbl))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(t2n(g_), np.asarray(w_), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("tile", [8, 16, 48])
def test_pooled_plain_bitwise_equals_striped_at_same_tile(tile, rng):
    bt, nb = 8, 6
    _, pol, q, k_qt, v_qt, mask, tbl = _pooled_attn_case(
        rng, 2, 2, 32, bt, nb, [47, 30, 9], fp8=False)
    k_qt, v_qt, tbl = j2t(k_qt), j2t(v_qt), torch.from_numpy(tbl)
    args = (torch.from_numpy(q), torch.from_numpy(mask), pol, 32, 0.2)
    bounds = seg.packed_block_bounds(args[1] > 0, tile)

    def run(kq, vq, **kw):
        return DA.decode_attn_plain(args[0], kq, vq, *args[1:],
                                    block_s=tile, block_bounds=bounds, **kw)
    pooled = run(k_qt, v_qt, block_table=tbl)
    striped = run(DA.gather_planes(k_qt, tbl), DA.gather_planes(v_qt, tbl))
    for a, b in zip(pooled, striped):
        assert torch.equal(a, b)


def _pooled_model_cache(rng, b=3, pool_blocks=20):
    """A pooled one-layer cache built by prefill + block insertion."""
    lens = [50, 33, 61]
    tbl = np.zeros((b, NB), np.int32)
    nxt = 1
    c = kvc.init_pooled_cache(b, MAX_LEN, 2, 16, TPOL, pool_blocks, BT,
                              torch.float32, device="cpu")
    for i, n in enumerate(lens):
        k = torch.from_numpy(rng.normal(size=(1, n, 2, 16)).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(1, n, 2, 16)).astype(np.float32))
        src = kvc.prefill(k, v, MAX_LEN, TPOL)
        used = -(-(n - KW["n_sink"] - KW["window"]) // BT)
        pairs = [(lb, nxt + lb) for lb in range(used)]
        tbl[i, :used] = [p for _, p in pairs]
        nxt += used
        kvc.insert_slot(c, i, src, 0)
        kvc.pool_insert_blocks(c, src, pairs)
    c["block_tbl"].copy_(torch.from_numpy(tbl))
    return c


@pytest.mark.parametrize("window", [0, 24])
def test_pooled_wrapper_matches_pallas_decode_attention(window, rng):
    c = _pooled_model_cache(rng)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    want = jax_cache_ops().attention(
        jnp.asarray(q), {k: jnp.asarray(v.numpy()) for k, v in c.items()},
        JPOL, scale=0.25, window=window, dtype=jnp.float32, interpret=True,
        block_s=BT)
    got = ops.cuda_decode_attention(torch.from_numpy(q), c, TPOL, scale=0.25,
                                    window=window, dtype=torch.float32)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    striped = ops.cuda_decode_attention(torch.from_numpy(q),
                                        kvc.unpool_cache(c), TPOL,
                                        scale=0.25, window=window,
                                        dtype=torch.float32)
    assert torch.equal(got, striped)
    rep = ops.decode_block_report(c, TPOL, 16, window=window)
    rs = ops.decode_block_report(kvc.unpool_cache(c), TPOL, 16,
                                 window=window)
    assert torch.equal(rep["bounds"], rs["bounds"])
    assert rep["total"] == rs["total"] == 1
    assert rep["bytes_per_block"] == rs["bytes_per_block"]


def test_decode_step_on_pooled_caches_equals_striped(params, rng):
    """Pooled leaves (L, NP+1, BT, H, W) and block_tbl (L, B, NB) slice per
    layer unchanged through decode_step, on both backends."""
    _, tp = params
    toks = torch.from_numpy(rng.integers(0, 64, (2, 45)))
    _, striped = T.prefill_model(tp, TCFG, toks, TPOL, max_len=MAX_LEN)
    g = striped["scan"]
    shapes = kvc.pooled_cache_shapes(2, MAX_LEN, 2, 16, TPOL, 12, BT,
                                     torch.float32)
    pooled = {"scan": {k: torch.zeros((2,) + s, dtype=d)
                       for k, (s, d) in shapes.items()}}
    kvc.insert_slot(pooled, 0, striped, 0, batch_axis=1)
    kvc.insert_slot(pooled, 1, striped, 1, batch_axis=1)
    # 25 packed prompt tokens fill logical blocks 0-3; the decode steps
    # below write blocks 3 and 4 of each slot's table
    tbl = np.asarray([[5, 2, 9, 3, 4, 0], [1, 12, 7, 6, 8, 0]])
    for row in range(2):
        kvc.pool_insert_blocks(pooled["scan"], striped["scan"],
                               [(lb, int(tbl[row, lb])) for lb in range(4)],
                               src_slot=row, pool_axis=1)
    pooled["scan"]["block_tbl"].copy_(torch.from_numpy(tbl)[None])
    assert T.cache_bytes(pooled) == sum(v.numel() * v.element_size()
                                        for v in pooled["scan"].values())
    for backend in ("reference", "cuda"):
        cs = {"scan": {k: v.clone() for k, v in g.items()}}
        cp = {"scan": {k: v.clone() for k, v in pooled["scan"].items()}}
        tok = toks[:, -1:]
        for _ in range(12):
            ls, cs = T.decode_step(tp, TCFG, tok, cs, TPOL, backend=backend)
            lp, cp = T.decode_step(tp, TCFG, tok, cp, TPOL, backend=backend)
            assert torch.equal(ls, lp), backend
            tok = ls[:, -1].argmax(-1, keepdim=True)
        un = kvc.unpool_cache({k: v[1] for k, v in cp["scan"].items()})
        for k, v in cs["scan"].items():
            assert torch.equal(un[k], v[1]), (backend, k)


# ------------------------------------------------------------ pooled Engine

def _shared_prefix_traffic(seed=5):
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 64, 37)
    tails = [3, 3, 9, 1, 0, 14]
    out = [np.concatenate([prefix, r.integers(0, 64, n)]).astype(np.int32)
           for n in tails]
    out[1] = out[0].copy()               # identical prompts share the tail
    return out


def _run_jax(jp, prompts, pool, slots=3, max_new=9):
    eng = JEngine(jp, JCFG, JPOL, batch_slots=slots, max_len=MAX_LEN,
                  backend="reference", steps_per_sync=4, pool_blocks=pool,
                  pool_block_tokens=BT)
    hs = [eng.submit(JRequest(prompt=p, max_new=max_new, seed=i))
          for i, p in enumerate(prompts)]
    eng.run(hs)
    return [h.tokens for h in hs], eng.stats()


def _run_port(tp, prompts, pool, backend, slots=3, max_new=9):
    eng = Engine(tp, TCFG, TPOL, batch_slots=slots, max_len=MAX_LEN,
                 backend=backend, steps_per_sync=4, pool_blocks=pool,
                 pool_block_tokens=BT, device="cpu")
    hs = [eng.submit(Request(prompt=p, max_new=max_new, seed=i))
          for i, p in enumerate(prompts)]
    eng.run(hs)
    assert eng.active_slots == 0 and eng.queue_depth == 0
    return [h.tokens for h in hs], eng


@pytest.fixture(scope="module")
def jax_pooled(params):
    return _run_jax(params[0], _shared_prefix_traffic(), 20)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_pooled_engine_equals_jax_and_striped(params, jax_pooled, backend):
    _, tp = params
    prompts = _shared_prefix_traffic()
    want, jst = jax_pooled
    got, eng = _run_port(tp, prompts, 20, backend)
    striped, _ = _run_port(tp, prompts, None, backend)
    assert got == want == striped
    st = eng.stats()
    for key in ("prefix_hits", "prefix_misses", "cow_copies", "peak_used",
                "striped_worst_case_bytes", "peak_resident_bytes"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert st["counters"]["admitted"] == len(prompts)
    assert st["used"] == 0 and st["reserved"] == 0
    audit = eng.check_invariants()["scan/L000"]
    assert audit["used"] == 0 and audit["free"] == 20
    # retired slots leave every per-slot leaf zero, tables included
    assert int(eng._caches["scan"]["length"].abs().sum()) == 0
    assert int(eng._caches["scan"]["block_tbl"].abs().sum()) == 0


def test_tight_pool_stalls_then_drains_fifo(params):
    _, tp = params
    prompts = [np.random.default_rng(i).integers(0, 64, 50).astype(np.int32)
               for i in range(4)]
    roomy, _ = _run_port(tp, prompts, 30, "cuda", slots=4, max_new=8)
    eng = Engine(tp, TCFG, TPOL, batch_slots=4, max_len=MAX_LEN,
                 backend="cuda", steps_per_sync=4, pool_blocks=13,
                 pool_block_tokens=BT, device="cpu")
    hs = [eng.submit(Request(prompt=p, max_new=8, seed=i))
          for i, p in enumerate(prompts)]
    stalled, order = False, []
    for _ in range(300):
        if all(h.finished for h in hs):
            break
        eng.step()
        stalled = stalled or "admission_stall" in eng.stats()
        order += [h.rid for h in hs if h.admit_time is not None
                  and h.rid not in order]
    assert all(h.finished for h in hs), "tight pool deadlocked"
    assert stalled and eng.stats()["counters"]["pool_exhausted_stalls"] > 0
    assert order == sorted(order)                         # FIFO
    assert [h.tokens for h in hs] == roomy
    eng.check_invariants()


def test_pool_validation_and_rejection(params):
    _, tp = params
    mk = lambda **kw: Engine(tp, TCFG, kw.pop("pol", TPOL), batch_slots=2,
                             max_len=kw.pop("max_len", MAX_LEN),
                             pool_block_tokens=kw.pop("bt", BT),
                             device="cpu", **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        mk(max_len=MAX_LEN + 1, pool_blocks=8)
    with pytest.raises(ValueError, match="pool_block_tokens"):
        mk(pool_blocks=8, bt=4)
    with pytest.raises(ValueError, match="no packed region"):
        mk(pool_blocks=8, pol=QuantPolicy(bits_k=16, bits_v=16,
                                          group_size=16, window=0,
                                          n_sink=0))
    with pytest.raises(ValueError, match="pool_blocks must be"):
        mk(pool_blocks=0)
    eng = mk(pool_blocks=3)
    with pytest.raises(ValueError, match="pool blocks"):
        eng.submit(Request(prompt=np.arange(50) % 64, max_new=8))
    info = eng.backend_info
    assert info["pooled"] and info["pool_blocks"] == 3
    per = kvc.pool_block_nbytes(2, 16, TPOL, BT) * TCFG.n_layers
    with pytest.warns(UserWarning, match="rounds down"):
        assert mk(pool_memory_bytes=5 * per + 1).pool_blocks == 5
    with pytest.raises(ValueError, match="cannot fit"):
        mk(pool_memory_bytes=per - 1)
    assert mk().stats() == {"pooled": False, "queue_depth": 0,
                            "active_slots": 0,
                            "counters": {"admitted": 0,
                                         "queue_wait_ticks": 0,
                                         "pool_exhausted_stalls": 0,
                                         "preemptions": 0,
                                         "spilled_blocks": 0,
                                         "restored_blocks": 0,
                                         "deadline_misses": 0,
                                         "cancelled": 0, "shed": 0,
                                         "nan_quarantines": 0,
                                         "watchdog_trips": 0,
                                         "cow_copies": 0}}


def test_pooled_serve_session_equals_jax(params):
    jp, tp = params
    prompts = np.random.default_rng(3).integers(0, 64, (2, 30)).astype(
        np.int32)
    prompts[1, :24] = prompts[0, :24]
    want = JSession(jp, JCFG, JPOL, batch_slots=2, max_len=MAX_LEN,
                    backend="reference", steps_per_sync=4, pool_blocks=12,
                    pool_block_tokens=BT).generate(prompts, max_new=11)
    sess = ServeSession(tp, TCFG, TPOL, batch_slots=2, max_len=MAX_LEN,
                        backend="cuda", steps_per_sync=4, pool_blocks=12,
                        pool_block_tokens=BT, device="cpu")
    got = sess.generate(prompts, max_new=11)
    np.testing.assert_array_equal(got, np.asarray(want))
    # both prompts quantize their one full block and tail from the same
    # 14 tokens: the second request hits both
    assert sess.engine.stats()["prefix_hits"] == 2
