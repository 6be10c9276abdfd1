"""Port SKVQ cache container vs the JAX reference, leaf for leaf and bit for
bit: ``prefill`` then ``decode_append`` through several window wrap-arounds
with ragged per-slot ``valid`` masks, with the plain quantizer and with the
kernel ``quant_fn`` on both sides; the slot lifecycle ops; byte
accounting; and the segment/bounds index math.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.policy import QuantPolicy as JPolicy
from repro.core import kv_cache as jkvc
from repro.core import segments as jseg
from repro.kernels.ops import make_kernel_quant_fn as j_kernel_qf

from repro_torch.core.policy import QuantPolicy
from repro_torch.core import kv_cache as kvc
from repro_torch.core import segments as seg
from repro_torch.core.quant import n_meta_groups
from repro_torch.kernels.ops import make_kernel_quant_fn
from test_torch_util import assert_tree_exact
from test_torch_util import (  # noqa: F401
    jax_cache_ops, jax_compile_cache, one_torch_thread)

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)


def _alpha(rng, h, g):
    return rng.uniform(0.75, 1.0, size=(h, g)).astype(np.float32)


@pytest.mark.parametrize("kw,kernel_quant", [
    (KW, False), (KW, True), (dict(KW, n_sink=0), False),
    (dict(KW, window=0, n_sink=2, bits_v=2.0), False),
    (dict(KW, window=0, n_sink=2, bits_v=2.0), True)])
def test_prefill_then_decode_append_exact(kernel_quant, kw, rng):
    pol_j, pol_t = JPolicy(**kw), QuantPolicy(**kw)
    ops = jax_cache_ops()
    b, s, h, d, max_len = 3, 13, 2, 32, 64
    ak = _alpha(rng, h, n_meta_groups(d, kw["bits_k"], 16))
    av = _alpha(rng, h, n_meta_groups(d, kw["bits_v"], 16))
    qf_j = j_kernel_qf(interpret=True) if kernel_quant else None
    qf_t = make_kernel_quant_fn() if kernel_quant else None
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    cj = ops.prefill(jnp.asarray(k), jnp.asarray(v), max_len, pol_j,
                     jnp.asarray(ak), jnp.asarray(av), quant_fn=qf_j)
    ct = kvc.prefill(torch.from_numpy(k), torch.from_numpy(v), max_len, pol_t,
                     torch.from_numpy(ak), torch.from_numpy(av),
                     quant_fn=qf_t)
    assert_tree_exact(ct, cj, "prefill")
    for step in range(24 if kernel_quant else 30):   # 2-3 ring wrap-arounds
        kn = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        vn = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        valid = rng.uniform(size=b) < 0.8
        cj = ops.append(cj, jnp.asarray(kn), jnp.asarray(vn), pol_j,
                        jnp.asarray(ak), jnp.asarray(av), quant_fn=qf_j,
                        valid=jnp.asarray(valid))
        out = kvc.decode_append(ct, torch.from_numpy(kn),
                                torch.from_numpy(vn), pol_t,
                                torch.from_numpy(ak), torch.from_numpy(av),
                                quant_fn=qf_t, valid=torch.from_numpy(valid))
        assert out is ct                          # in place
        if step % 8 == 7:
            assert_tree_exact(ct, cj, f"step {step}")
    assert_tree_exact(ct, cj, "final")


def test_short_prompts_fill_sinks_first(rng):
    pol_j, pol_t = JPolicy(**KW), QuantPolicy(**KW)
    k = rng.normal(size=(2, 2, 2, 32)).astype(np.float32)
    ops = jax_cache_ops()
    cj = ops.prefill(jnp.asarray(k), jnp.asarray(k), 40, pol_j)
    ct = kvc.prefill(torch.from_numpy(k), torch.from_numpy(k), 40, pol_t)
    for _ in range(20):
        kn = rng.normal(size=(2, 1, 2, 32)).astype(np.float32)
        cj = ops.append(cj, jnp.asarray(kn), jnp.asarray(kn), pol_j)
        kvc.decode_append(ct, torch.from_numpy(kn), torch.from_numpy(kn),
                          pol_t)
    assert_tree_exact(ct, cj)


def test_slot_lifecycle_exact(rng):
    pol_j, pol_t = JPolicy(**KW), QuantPolicy(**KW)
    k = rng.normal(size=(3, 30, 2, 32)).astype(np.float32)
    src = rng.normal(size=(1, 17, 2, 32)).astype(np.float32)
    ops = jax_cache_ops()
    cj = ops.prefill(jnp.asarray(k), jnp.asarray(k), 48, pol_j)
    ct = kvc.prefill(torch.from_numpy(k), torch.from_numpy(k), 48, pol_t)
    sj = ops.prefill(jnp.asarray(src), jnp.asarray(src), 48, pol_j)
    st = kvc.prefill(torch.from_numpy(src), torch.from_numpy(src), 48, pol_t)
    cj = jkvc.insert_slot(jkvc.reset_slot(cj, 1), 2, sj)
    kvc.insert_slot(kvc.reset_slot(ct, 1), 2, st)
    assert_tree_exact(ct, cj)
    np.testing.assert_array_equal(kvc.slot_lengths(ct).numpy(),
                                  np.asarray(jkvc.slot_lengths(cj)))
    # layer-stacked groups, batch axis 1 (the engine's layout)
    gj = {"scan": {kk: jnp.stack([vv, vv]) for kk, vv in cj.items()}}
    gt = {"scan": {kk: torch.stack([vv, vv]) for kk, vv in ct.items()}}
    assert_tree_exact(kvc.reset_slot(gt, 0, batch_axis=1),
                      jkvc.reset_slot(gj, 0, batch_axis=1))


@pytest.mark.parametrize("kw", [KW, dict(bits_k=16.0, bits_v=16.0,
                                         clip=False, reorder=False, window=0,
                                         n_sink=0)])
def test_cache_shapes_and_bytes(kw):
    pol_j, pol_t = JPolicy(**kw), QuantPolicy(**kw)
    want = jkvc.cache_shapes(2, 100, 8, 64, pol_j)
    got = kvc.cache_shapes(2, 100, 8, 64, pol_t)
    assert {k: s for k, (s, _) in got.items()} == \
        {k: s for k, (s, _) in want.items()}
    assert kvc.policy_cache_nbytes(4096, 32, 128, pol_t) == \
        jkvc.policy_cache_nbytes(4096, 32, 128, pol_j)


def test_segment_math_exact(rng):
    lens = np.asarray([0, 3, 11, 26, 70], np.int32)
    lt = torch.from_numpy(lens)
    for jf, tf in ((lambda L: jseg.sink_segment(4, L),
                    lambda L: seg.sink_segment(4, L)),
                   (lambda L: jseg.window_segment(8, 4, L),
                    lambda L: seg.window_segment(8, 4, L)),
                   (lambda L: jseg.packed_segment(jnp.arange(64), L, 4, 8),
                    lambda L: seg.packed_segment(torch.arange(64), L, 4, 8))):
        for a, b in zip(tf(lt), jf(jnp.asarray(lens))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = rng.uniform(size=(6, 64)) < 0.05
    ok[0] = False
    np.testing.assert_array_equal(
        seg.packed_block_bounds(torch.from_numpy(ok), 16).numpy(),
        np.asarray(jseg.packed_block_bounds(jnp.asarray(ok), 16)))
    for w in (0, 5):
        pos, st = seg.window_segment(8, 4, lt)
        got = seg.attend_ok(pos, st, lt - 1, seg.effective_window(w))
        pj, sj = jseg.window_segment(8, 4, jnp.asarray(lens))
        want = jseg.attend_ok(pj, sj, jnp.asarray(lens) - 1,
                              jseg.effective_window(jnp.int32(w)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partials_merge_match(rng):
    qg = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    kv = [rng.normal(size=(2, 10, 2, 16)).astype(np.float32) for _ in range(4)]
    ok = rng.uniform(size=(2, 10)) < 0.6
    pj = [jseg.partial_attend(jnp.asarray(qg), jnp.asarray(kv[i]),
                              jnp.asarray(kv[i + 1]), jnp.asarray(ok), 0.25,
                              cap) for i, cap in ((0, 0.0), (2, 20.0))]
    pt = [seg.partial_attend(torch.from_numpy(qg), torch.from_numpy(kv[i]),
                             torch.from_numpy(kv[i + 1]), torch.from_numpy(ok),
                             0.25, cap) for i, cap in ((0, 0.0), (2, 20.0))]
    np.testing.assert_allclose(seg.finalize(pt).numpy(),
                               np.asarray(jseg.finalize(pj)), atol=1e-6,
                               rtol=1e-5)
