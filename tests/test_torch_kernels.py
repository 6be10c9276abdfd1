"""Port decode attention vs the JAX reference: the decode_attn kernel's
plain version against ``decode_attn_pallas`` (interpret mode) and
``kernels.ref.decode_attn_ref``, the pruning identity, and the ops wrapper
against ``pallas_decode_attention`` on ragged per-slot lengths across ring
wrap-around.  The CUDA kernel itself is held to its plain version on the
card in tests/test_torch_cuda.py.

Tolerance: f32 ``atol=3e-5, rtol=1e-4`` — that of tests/test_kernels.py:
the two sides sum the same f32 products in different orders.  The pruned
walk is held BITWISE to the full walk: a dead tile is an exact no-op.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.policy import QuantPolicy as JPolicy
from repro.core import kv_cache as jkvc
from repro.core.quant import quantize_groups as j_quantize
from repro.kernels.decode_attn import decode_attn_pallas
from repro.kernels import ref as R
from repro.kernels.ops import pallas_decode_attention

from repro_torch.core.policy import QuantPolicy
from repro_torch.core import segments as seg
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import ops
from test_torch_util import j2t, t2n

ATOL, RTOL = 3e-5, 1e-4


def _planes(rng, b, s, hkv, d, bits_k, bits_v, gs, fp8_meta=True):
    k = jnp.asarray(rng.normal(size=(b, s, hkv, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, s, hkv, d)), jnp.float32)
    g = min(gs, d)
    return (j_quantize(k, bits_k, g, fp8_meta=fp8_meta),
            j_quantize(v, bits_v, g, fp8_meta=fp8_meta))


CASES = [  # bits_k, bits_v, gs, d, s, gq, hkv, softcap, fp8_meta
    (2.0, 1.5, 64, 128, 512, 1, 2, 0.0, True),    # paper headline, MHA
    (2.0, 1.5, 64, 64, 256, 4, 2, 0.0, True),     # GQA
    (4.0, 4.0, 32, 64, 256, 2, 2, 30.0, True),    # softcap
    (2.0, 2.0, 32, 64, 256, 4, 1, 0.0, False),    # fp16 metadata
]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case, rng):
    bk, bv, gs, d, s, gq, hkv, cap, fp8 = case
    pol_j = JPolicy(bits_k=bk, bits_v=bv, group_size=gs, window=0, n_sink=0,
                    fp8_meta=fp8)
    pol_t = QuantPolicy(bits_k=bk, bits_v=bv, group_size=gs, window=0,
                        n_sink=0, fp8_meta=fp8)
    b = 2
    k_qt, v_qt = _planes(rng, b, s, hkv, d, bk, bv, gs, fp8)
    q = rng.normal(size=(b, hkv, gq, d)).astype(np.float32)
    mask = (rng.uniform(size=(b, s)) < 0.7).astype(np.float32)
    mask[1, s // 2:] = 0.0            # a dead tail for slot 1
    scale = d ** -0.5
    want = decode_attn_pallas(jnp.asarray(q), k_qt, v_qt, jnp.asarray(mask),
                              pol_j, d, scale, interpret=True, block_s=128,
                              softcap=cap)
    got = DA.decode_attn(torch.from_numpy(q), j2t(k_qt), j2t(v_qt),
                         torch.from_numpy(mask), pol_t, d, scale,
                         block_s=128, softcap=cap)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(t2n(g_), np.asarray(w_), atol=ATOL,
                                   rtol=RTOL)


def test_plain_matches_ref_oracle(rng):
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0,
                      n_sink=0)
    pol_j = JPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0, n_sink=0)
    b, s, hkv, d, gq, qc = 2, 512, 2, 128, 4, 400
    k_qt, v_qt = _planes(rng, b, s, hkv, d, 2.0, 1.5, 64)
    q = rng.normal(size=(b, hkv, gq, d)).astype(np.float32)
    mask = np.broadcast_to((np.arange(s) < qc).astype(np.float32), (b, s))
    num, m, l = DA.decode_attn(torch.from_numpy(q), j2t(k_qt), j2t(v_qt),
                               torch.from_numpy(mask.copy()), pol, d,
                               d ** -0.5)
    o, m_r, l_r = R.decode_attn_ref(jnp.asarray(q), k_qt, v_qt, qc, pol_j,
                                    d, d ** -0.5)
    out = t2n(num) / t2n(l)
    np.testing.assert_allclose(out, np.asarray(o) / np.asarray(l_r)[..., None],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t2n(m)[..., 0], np.asarray(m_r), atol=ATOL,
                               rtol=RTOL)


def _ragged(rng, s_mask=1024, b=4, hkv=2, gq=2, d=64, bs=256):
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0,
                      n_sink=0)
    k_qt, v_qt = _planes(rng, b, s_mask - 40, hkv, d, 2.0, 1.5, 64)
    live = np.asarray([0, 90, 600, 980])[:b]
    j = np.arange(s_mask)
    lo = np.asarray([0, 0, 300, 500])[:b]          # local-window lower edge
    mask = ((j[None] < live[:, None]) & (j[None] >= lo[:, None]))
    mask = torch.from_numpy(mask.astype(np.float32))
    bounds = seg.packed_block_bounds(mask > 0, bs)
    q = torch.from_numpy(rng.normal(size=(b, hkv, gq, d)).astype(np.float32))
    return pol, q, j2t(k_qt), j2t(v_qt), mask, bounds, d, bs


def test_pruned_walk_bitwise_equals_full_walk(rng):
    pol, q, k_qt, v_qt, mask, bounds, d, bs = _ragged(rng)
    assert bounds.tolist() == [[0, 0], [0, 1], [1, 3], [1, 4]]
    full = DA.decode_attn(q, k_qt, v_qt, mask, pol, d, 0.125, block_s=bs)
    pruned = DA.decode_attn(q, k_qt, v_qt, mask, pol, d, 0.125, block_s=bs,
                            block_bounds=bounds)
    for a, b in zip(full, pruned):
        assert torch.equal(a, b)


def _wrapped_caches(rng, pol_j, lens, max_len, h=2, d=32, steps=0):
    """A ragged JAX cache: prefill to each slot's own length (batch-of-1,
    inserted), then ``steps`` decode appends through ring wrap-around."""
    b = len(lens)
    cache = jkvc.init_cache(b, max_len, h, d, pol_j, jnp.float32)
    for i, n in enumerate(lens):
        k = jnp.asarray(rng.normal(size=(1, n, h, d)), jnp.float32)
        v = jnp.asarray(rng.normal(size=(1, n, h, d)), jnp.float32)
        cache = jkvc.insert_slot(cache, i, jkvc.prefill(k, v, max_len, pol_j))
    for _ in range(steps):
        kn = jnp.asarray(rng.normal(size=(b, 1, h, d)), jnp.float32)
        vn = jnp.asarray(rng.normal(size=(b, 1, h, d)), jnp.float32)
        cache = jkvc.decode_append(cache, kn, vn, pol_j)
    return cache


@pytest.mark.parametrize("prune", [True, False])
def test_ops_wrapper_matches_pallas_decode_attention(prune, rng):
    kw = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
    pol_j, pol_t = JPolicy(**kw), QuantPolicy(**kw)
    cache = _wrapped_caches(rng, pol_j, [3, 11, 30, 57], max_len=80, steps=13)
    q = jnp.asarray(rng.normal(size=(4, 1, 4, 32)), jnp.float32)
    want = pallas_decode_attention(q, cache, pol_j, scale=32 ** -0.5,
                                   dtype=jnp.float32, interpret=True,
                                   block_s=16, prune_blocks=prune)
    got = ops.cuda_decode_attention(j2t({"q": q})["q"], j2t(cache), pol_t,
                                    scale=32 ** -0.5, dtype=torch.float32,
                                    block_s=16, prune_blocks=prune)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_block_report_matches_reference(rng):
    from repro.kernels.ops import decode_block_report as j_report
    kw = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
    cache = _wrapped_caches(rng, JPolicy(**kw), [3, 40, 70], max_len=80,
                            steps=5)
    want = j_report(cache, JPolicy(**kw), 32, block_s=16)
    got = ops.decode_block_report(j2t(cache), QuantPolicy(**kw), 32,
                                  block_s=16)
    np.testing.assert_array_equal(got["bounds"].numpy(),
                                  np.asarray(want["bounds"]))
    np.testing.assert_array_equal(got["visited"].numpy(),
                                  np.asarray(want["visited"]))
    assert (got["total"], got["bytes_per_block"]) == \
        (want["total"], want["bytes_per_block"])
