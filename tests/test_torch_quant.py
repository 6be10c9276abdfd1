"""Port quantization core vs the JAX reference, byte for byte: fp8 metadata,
bit packing, ``quantize_groups`` and the kv_quant kernel's plain version
(CPU).  The CUDA kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py.

Every comparison here is EXACT: codes, scale and zero bytes (fp16 metadata
by bit pattern) must match ``repro.core.quant.quantize_groups``, including
the edge cases — constant rows, groups whose step rounds to fp8 zero
(NaN -> code 0, +inf -> top code), metadata beyond ±448 (saturated) and
bf16 inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fp8 as jfp8
from repro.core import packing as jpack
from repro.core.quant import quantize_groups as j_quantize, n_meta_groups
from repro.kernels.kv_quant import kv_quant_pallas

from repro_torch.core import fp8 as tfp8
from repro_torch.core import packing as tpack
from repro_torch.core.quant import quantize_groups as t_quantize
from repro_torch.kernels import kv_quant as KQ
from test_torch_util import assert_tree_exact, j2t
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

BITS = [1.0, 1.5, 2.0, 4.0, 8.0]


def _x(rng, n, d, dtype=np.float32, scale=1.0):
    return (rng.normal(size=(n, d)) * scale).astype(dtype)


def _pair(x_np, dtype):
    """Same values as a JAX array and a CPU tensor."""
    xj = jnp.asarray(x_np, dtype)
    return xj, j2t({"x": xj})["x"]


def test_fp8_encode_decode_exact(rng):
    # dense sweep incl. exact ties between E4M3 neighbours, subnormals,
    # and values past the ±448 saturation point
    grid = np.concatenate([
        np.linspace(-600, 600, 20001), rng.normal(size=20000) * 3,
        np.ldexp(np.arange(-12, 10, dtype=np.float64), 0),
        np.asarray([0.0, 2 ** -10, 2 ** -9, 1.5 * 2 ** -9, 464, 480, 1e9,
                    -1e9])]).astype(np.float32)
    xj, xt = _pair(grid, jnp.float32)
    enc_t = tfp8.encode_fp8(xt)
    np.testing.assert_array_equal(enc_t.numpy(),
                                  np.asarray(jfp8.encode_fp8(xj)))
    np.testing.assert_array_equal(
        tfp8.decode_fp8(enc_t).numpy(),
        np.asarray(jfp8.decode_fp8(jfp8.encode_fp8(xj))))
    for use_fp8 in (True, False):
        np.testing.assert_array_equal(
            tfp8.quantize_meta(xt, use_fp8).numpy().view(np.uint32),
            np.asarray(jfp8.quantize_meta(xj, use_fp8)).view(np.uint32))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_exact(bits, rng):
    codes = rng.integers(0, 2 ** bits, size=(3, 5, 64)).astype(np.uint8)
    want = np.asarray(jpack.pack(jnp.asarray(codes), bits))
    got = tpack.pack(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpack.unpack_u8(got, bits).numpy(), codes)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("fp8_meta", [True, False])
@pytest.mark.parametrize("alpha_kind", ["none", "shared", "per_row"])
def test_quantize_groups_exact(bits, fp8_meta, alpha_kind, rng):
    n, d, gs = 48, 64, 16
    xj, xt = _pair(_x(rng, n, d, scale=2.0), jnp.float32)
    g = n_meta_groups(d, bits, gs)
    alpha = {"none": None,
             "shared": rng.uniform(0.7, 1.0, size=(g,)).astype(np.float32),
             "per_row": rng.uniform(0.7, 1.0, size=(n, g)).astype(np.float32)
             }[alpha_kind]
    aj = None if alpha is None else jnp.asarray(alpha)
    at = None if alpha is None else torch.from_numpy(alpha)
    want = j_quantize(xj, bits, gs, aj, fp8_meta)
    assert_tree_exact(t_quantize(xt, bits, gs, at, fp8_meta), want)
    assert_tree_exact(KQ.kv_quant(xt, bits, gs, at, fp8_meta), want)


def _edge_rows(rng, d):
    """Constant rows, tiny-range rows whose fp8 step rounds to zero, rows
    whose metadata saturates past ±448, and ordinary rows."""
    rows = [np.zeros(d), np.full(d, 0.5), np.full(d, -3.0),
            rng.uniform(0.0, 1e-3, d), rng.uniform(-2e-4, 2e-4, d),
            np.concatenate([[0.0], rng.uniform(0.0, 1e-3, d - 1)]),
            rng.normal(size=d) * 900.0, rng.normal(size=d) - 1000.0,
            rng.normal(size=d) * 3.0]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("bits", [1.5, 2.0, 4.0])
@pytest.mark.parametrize("fp8_meta", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quant_edge_cases_exact(bits, fp8_meta, dtype, rng):
    xj, xt = _pair(_edge_rows(rng, 64), dtype)
    want = j_quantize(xj, bits, 32, None, fp8_meta)
    assert_tree_exact(t_quantize(xt, bits, 32, None, fp8_meta), want)
    assert_tree_exact(KQ.kv_quant(xt, bits, 32, None, fp8_meta), want)


def test_tiny_range_row_codes(rng):
    """The documented reference behaviour: [0, 0.001) at 2 bits has an fp8
    step of 0, so x == lo gives 0/0 = NaN -> code 0, the rest +inf -> 3."""
    x = np.concatenate([[0.0], rng.uniform(1e-5, 1e-3, 127)]).astype(np.float32)
    qt = t_quantize(torch.from_numpy(x[None]), 2.0, 128)
    codes = tpack.unpack_u8(qt["codes_hi"], 2).numpy()[0]
    assert qt["scale_hi"].item() == 0 and codes[0] == 0
    assert (codes[1:] == 3).all()


@pytest.mark.parametrize("bits,gs,d", [(2.0, 64, 128), (1.5, 64, 128),
                                       (1.0, 16, 64), (4.0, 32, 64)])
def test_plain_matches_pallas_within_448(bits, gs, d, rng):
    """Against the TPU kernel itself (interpret mode) where its unsaturated
    fp8 metadata agrees with the reference: |meta| < 448."""
    xj, xt = _pair(_x(rng, 128, d, scale=2.0), jnp.float32)
    alpha = rng.uniform(0.8, 1.0, size=(128, n_meta_groups(d, bits, gs)))
    alpha = alpha.astype(np.float32)
    want = kv_quant_pallas(xj, bits, gs, alpha=jnp.asarray(alpha),
                           interpret=True, block_t=64)
    assert_tree_exact(KQ.kv_quant(xt, bits, gs, torch.from_numpy(alpha)),
                      want)


def test_plain_counter_counts_cpu_calls(rng):
    before = KQ.LAUNCHES["plain"]
    KQ.kv_quant(torch.from_numpy(_x(rng, 4, 64)), 2.0, 64)
    assert KQ.LAUNCHES["plain"] == before + 1
