"""The fused decode append and the bulk quantizer's host side against the
JAX package on the same inputs.

* ``kernels.kv_quant.kv_append`` on CPU tensors (its plain version) equals
  the JAX ``decode_append`` with the Pallas quantizer in interpret mode
  (``make_kernel_quant_fn(interpret=True)``: the
  ``PallasBackend(kernel_quant=True)`` path), leaf for leaf and bit for
  bit, striped and pooled, with and without a window, over 2-3 ring wraps
  with random ``valid`` rows.  Tolerance: exact.  The null pool block 0,
  where both sides steer rows that write nothing, is excluded.
* The launch-argument checks, which run without a card.
* The ``"cuda"`` backend's ``decode_step`` appends through ``kv_append``.
* Per-head clip factors pass through ``make_kernel_quant_fn`` untiled.
* A group whose minimum is a zero stores the zero byte of XLA's signed
  minimum (-0 below +0), whatever order torch meets the zeros in.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import quantize_groups as j_quantize
from repro.kernels.kv_quant import kv_quant_pallas
from repro.kernels.ops import make_kernel_quant_fn as j_kernel_qf

from repro_torch import configs
from repro_torch.core import kv_cache as kvc
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import n_meta_groups, quantize_groups
from repro_torch.kernels import kv_quant as KQ
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import transformer as T
from test_torch_util import assert_tree_exact
from test_torch_util import (  # noqa: F401
    jax_cache_ops, jax_compile_cache, one_torch_thread)

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, n_sink=3)
B, H, D, BT, NB = 4, 2, 32, 4, 6


def _random_cache(rng, cache, lengths, tbl=None):
    """Fill every leaf of a fresh torch cache with seeded contents."""
    for key, v in cache.items():
        if key == "length":
            v.copy_(torch.as_tensor(lengths))
        elif key == "block_tbl":
            v.copy_(torch.from_numpy(tbl))
        elif v.is_floating_point():
            v.copy_(torch.from_numpy(rng.normal(size=v.shape)
                                     .astype(np.float32)))
        else:
            v.copy_(torch.from_numpy(rng.integers(0, 256, v.shape)
                                     .astype(np.uint8)))
    return cache


def _null_block_zeroed(cache):
    return {k: (v.at[0].set(0) if hasattr(v, "at") else
                torch.cat([torch.zeros_like(v[:1]), v[1:]]))
            if kvc.is_plane_key(k) else v for k, v in cache.items()}


@pytest.mark.parametrize("window", [8, 0])
@pytest.mark.parametrize("pooled", [False, True])
def test_kv_append_cpu_equals_jax_decode_append(pooled, window, rng):
    kw = dict(KW, window=window)
    pol_j, pol_t = JPolicy(**kw), QuantPolicy(**kw)
    max_len = kw["n_sink"] + window + NB * BT        # 24 packed tokens
    if pooled:
        ct = kvc.init_pooled_cache(B, max_len, H, D, pol_t, B * NB, BT,
                                   torch.float32, device="cpu")
        tbl = rng.permutation(np.arange(1, B * NB + 1)).reshape(B, NB)
    else:
        ct = kvc.init_cache(B, max_len, H, D, pol_t, torch.float32,
                            device="cpu")
        tbl = None
    # sinks filling, window filling, evicting, and near the capacity
    lengths = [0, 2, kw["n_sink"] + window + 2, max_len - 6]
    _random_cache(rng, ct, lengths, None if tbl is None else
                  tbl.astype(np.int32))
    # a copy: jnp.asarray would alias the torch buffers that kv_append
    # then writes in place, racing the reference's asynchronous append
    cj = {k: jnp.array(v.numpy()) for k, v in ct.items()}
    ak = rng.uniform(0.75, 1.0, (H, n_meta_groups(D, 2.0, 16))
                     ).astype(np.float32)
    av = rng.uniform(0.75, 1.0, (H, n_meta_groups(D, 1.5, 16))
                     ).astype(np.float32)
    qf_j = j_kernel_qf(interpret=True)
    before = KQ.LAUNCHES["append_plain"]
    steps = 20                         # > 2 wraps of the 8-token ring
    for step in range(steps):
        kn = rng.normal(size=(B, 1, H, D)).astype(np.float32)
        vn = rng.normal(size=(B, 1, H, D)).astype(np.float32)
        valid = None if step % 4 == 3 else rng.uniform(size=B) < 0.75
        cj = jax_cache_ops().append(
            cj, jnp.asarray(kn), jnp.asarray(vn), pol_j, jnp.asarray(ak),
            jnp.asarray(av), quant_fn=qf_j,
            valid=None if valid is None else jnp.asarray(valid))
        out = KQ.kv_append(ct, torch.from_numpy(kn), torch.from_numpy(vn),
                           pol_t, torch.from_numpy(ak), torch.from_numpy(av),
                           valid=None if valid is None
                           else torch.from_numpy(valid))
        assert out is ct                                   # in place
    assert KQ.LAUNCHES["append_plain"] == before + steps
    lens = ct["length"].numpy()
    assert lens[0] > kw["n_sink"] and lens[3] > max_len    # past capacity
    if pooled:
        cj, ct = _null_block_zeroed(cj), _null_block_zeroed(ct)
    assert_tree_exact(ct, cj, f"pooled={pooled} window={window}")


def _args_case(case):
    pol = QuantPolicy(**dict(KW, window=8))
    d, ak = D, None
    if case == "fp16":
        pol = QuantPolicy(bits_k=16.0, bits_v=16.0, clip=False,
                          reorder=False, window=0, n_sink=0)
    elif case == "group":
        pol = QuantPolicy(**dict(KW, window=8, group_size=12))
    cache = kvc.init_cache(2, 40, H, d, pol, torch.float32, device="cpu")
    if case == "noncontiguous":
        cache["win_k"] = torch.zeros(2, 8, H, 2 * d)[..., :d]
    elif case == "alpha":
        ak = torch.ones(3, n_meta_groups(d, 2.0, 16))       # 3 !| H = 2
    kn = torch.zeros(2, 1, H, d)
    return cache, kn, pol, ak


@pytest.mark.parametrize("case,err,match", [
    ("noncontiguous", ValueError, "contiguous"),
    ("alpha", ValueError, "alpha"),
    ("fp16", NotImplementedError, "fp16"),
    ("group", ValueError, "group 12"),
])
def test_append_launch_args_reject(case, err, match):
    cache, kn, pol, ak = _args_case(case)
    with pytest.raises(err, match=match):
        KQ.append_launch_args(cache, kn, kn.clone(), pol, ak)


def test_append_launch_args_accept_both_layouts():
    pol = QuantPolicy(**dict(KW, window=8))
    ak = torch.ones(H, n_meta_groups(D, 2.0, 16))
    kn = torch.zeros(B, 1, H, D)
    striped = kvc.init_cache(B, 40, H, D, pol, torch.float32, device="cpu")
    pooled = kvc.init_pooled_cache(B, 8 + 3 + NB * BT, H, D, pol, 9, BT,
                                   torch.float32, device="cpu")
    a = KQ.append_launch_args(striped, kn, kn.clone(), pol, ak, None,
                              valid=torch.ones(B, dtype=torch.bool))
    assert a["dims"] == (H, 8, 3, 40 - 11, 0, 0, 0)
    assert a["alphas"]["qk"][1] == H and a["alphas"]["qv"] == (None, 0)
    p = KQ.append_launch_args(pooled, kn, kn.clone(), pol)
    assert p["dims"] == (H, 8, 3, NB * BT, BT, NB, 10)
    assert "block_tbl" in p["tensors"] and p["valid"] is None


def test_cuda_backend_decode_step_appends_through_kv_append():
    """On CPU the ``"cuda"`` backend's decode step appends through
    ``kv_append`` (its plain version): one call per layer per step, and
    the reference backend through ``decode_append`` directly."""
    cfg = configs.get_smoke("llama2_7b")
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(0))
    _, caches = T.prefill_model(params, cfg, toks, pol, max_len=40,
                                backend="cuda")
    reset_launch_counts()
    tok = toks[:, -1:]
    for step in range(1, 4):
        _, caches = T.decode_step(params, cfg, tok, caches, pol,
                                  backend="cuda")
        c = launch_counts()["kv_quant"]
        assert (c["append_plain"], c["append"]) == (cfg.n_layers * step, 0)
    T.decode_step(params, cfg, tok, caches, pol, backend="reference")
    assert launch_counts()["kv_quant"]["append_plain"] == cfg.n_layers * 3
    assert (caches["scan"]["length"] == 20 + 4).all()


def test_make_kernel_quant_fn_passes_per_head_alpha_untiled(rng,
                                                            monkeypatch):
    x = rng.normal(size=(2, 5, 3, D)).astype(np.float32)
    alpha = rng.uniform(0.7, 1.0, (3, n_meta_groups(D, 1.5, 16))
                        ).astype(np.float32)
    seen, real = [], ops.kv_quant

    def spy(rows, bits, gs, alpha=None, fp8_meta=True):
        seen.append(tuple(alpha.shape))
        return real(rows, bits, gs, alpha=alpha, fp8_meta=fp8_meta)
    monkeypatch.setattr(ops, "kv_quant", spy)
    got = ops.make_kernel_quant_fn()(torch.from_numpy(x), 1.5, 16,
                                     torch.from_numpy(alpha), True)
    assert seen == [alpha.shape]
    tiled = np.broadcast_to(alpha, (2, 5) + alpha.shape).reshape(30, -1)
    want = KQ.kv_quant_plain(torch.from_numpy(x).reshape(30, D), 1.5, 16,
                             torch.from_numpy(np.ascontiguousarray(tiled)))
    for k, v in want.items():
        assert torch.equal(got[k].reshape(30, -1), v), k
    assert_tree_exact(got, j_kernel_qf(interpret=True)(
        jnp.asarray(x), 1.5, 16, jnp.asarray(alpha), True))


def _signed_zero_rows(rng, n, d):
    """Rows whose first 16 channels (a group) hold zeros next to positive
    values, so that the group's minimum is a zero: +0 before -0, -0
    before +0, +0 only; all-zero rows of mixed signs; ordinary rows."""
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    for i in range(n):
        kind = i % 5
        p = np.sort(rng.permutation(16)[:6])
        if kind == 0:
            x[i, p[:3]], x[i, p[3:]] = 0.0, -0.0
        elif kind == 1:
            x[i, p[:3]], x[i, p[3:]] = -0.0, 0.0
        elif kind == 2:
            x[i, p] = 0.0
        elif kind == 3:
            x[i] = np.where(rng.uniform(size=d) < 0.5, 0.0, -0.0)
        else:
            x[i] -= 0.5
    return x


@pytest.mark.parametrize("bits", [2.0, 1.5])
@pytest.mark.parametrize("fp8_meta", [True, False])
def test_quantize_groups_signed_zero_minimum_matches_jax(bits, fp8_meta,
                                                         rng):
    x = _signed_zero_rows(rng, 20, D)
    got = quantize_groups(torch.from_numpy(x), bits, 16, fp8_meta=fp8_meta)
    assert_tree_exact(got, j_quantize(jnp.asarray(x), bits, 16,
                                      fp8_meta=fp8_meta), "jnp")
    assert_tree_exact(got, kv_quant_pallas(jnp.asarray(x), bits, 16,
                                           fp8_meta=fp8_meta, interpret=True,
                                           block_t=20), "pallas")
    if fp8_meta:                         # both signs of zero bytes occur
        zeros = got["zero_hi"].numpy()
        assert (zeros == 0x80).any() and (zeros == 0x00).any()
