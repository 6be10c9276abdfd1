"""Port dense model vs the JAX reference at the SMOKE shapes of llama3.2-1b
(GQA) and llama2-7b (MHA), in f32, with a NON-identity calibration (random
channel permutations, clip factors alpha != 1).

Backends are paired by dequant precision — port ``"cuda"`` (plain kernel
versions on the CPU) with JAX ``"pallas"`` (interpret mode), port
``"reference"`` with JAX ``"reference"``; all four dequantize in f32 here.

Tolerances, and why:
* logits: ``atol = rtol = 2e-4``.  Both sides run the same f32 math, but
  torch (oneDNN/MKL) and XLA sum matmuls and einsums in different orders,
  so values agree to ~1e-6 relative per op; 2e-4 leaves room for that to
  compound over two layers and the 256-way unembedding without hiding a
  wrong mask, scale, permutation or RoPE (each of which moves logits by
  1e-2 or more).
* cache codes: at most 0.5% of packed bytes may differ.  K/V that differ in
  the last bit can land on opposite sides of a rounding edge of
  ``(x - lo) / h`` and flip one code — the ROADMAP's flip-rate allowance —
  but a layout or plane error changes most bytes.  fp sink/window values:
  ``atol = rtol = 1e-5``; lengths exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import n_meta_groups
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.core.policy import QuantPolicy
from repro_torch.convert import calib_from_numpy, params_from_numpy
from repro_torch.models import transformer as T
from test_torch_util import j2t, t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3


def _calib(cfg, rng):
    n, h, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    perm = lambda: np.stack([np.stack([rng.permutation(d) for _ in range(h)])
                             for _ in range(n)]).astype(np.int32)
    gk = n_meta_groups(d, KW["bits_k"], min(KW["group_size"], d))
    gv = n_meta_groups(d, KW["bits_v"], min(KW["group_size"], d))
    return {"perm_k": perm(), "perm_v": perm(),
            "alpha_k": rng.uniform(0.8, 1.0, (n, h, gk)).astype(np.float32),
            "alpha_v": rng.uniform(0.8, 1.0, (n, h, gv)).astype(np.float32)}


def _setup(arch, rng):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    cal = _calib(jcfg, rng)
    jcal = {k: jnp.asarray(v) for k, v in cal.items()}
    tcal = calib_from_numpy(cal, device="cpu")
    return jcfg, tcfg, jp, tp, jcal, tcal


@functools.lru_cache(maxsize=None)
def _jfns(jcfg, jb):
    """The reference's prefill and decode step for one (config, backend),
    jitted once and shared by every step (run eagerly, each call
    dispatched its ops, and the Pallas kernels' interpreter, one by
    one)."""
    pol = JPolicy(**KW)
    prefill = jax.jit(lambda p, t, c: JT.prefill_model(
        p, jcfg, {"tokens": t}, pol, calib=c, max_len=64, backend=jb))
    step = jax.jit(lambda p, t, caches, c: JT.decode_step(
        p, jcfg, t, caches, pol, calib=c, backend=jb))
    return prefill, step


def _compare_caches(ct, cj):
    cj = jax.tree.map(np.asarray, cj)
    for k, want in cj["scan"].items():
        got = ct["scan"][k].numpy()
        if k == "length":
            np.testing.assert_array_equal(got, want)
        elif k.startswith(("sink_", "win_")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            rate = float(np.mean(got != want))
            assert rate <= FLIP_RATE, (k, rate)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "llama2_7b"])
@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(arch, tb, jb, rng):
    jcfg, tcfg, jp, tp, jcal, tcal = _setup(arch, rng)
    pol_t = QuantPolicy(**KW)
    toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    jprefill, jstep = _jfns(jcfg, jb)
    lj, cj = jprefill(jp, jnp.asarray(toks), jcal)
    lt, ct = T.prefill_model(tp, tcfg, torch.from_numpy(toks), pol_t,
                             calib=tcal, max_len=64, backend=tb)
    np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _compare_caches(ct, cj)
    # decode from the SAME cache (the JAX one, carried over) so logits
    # compare the decode math alone; tokens fed identically to both
    ct = j2t(cj)
    for step in range(5):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = jstep(jp, jnp.asarray(tok), cj, jcal)
        lt, ct = T.decode_step(tp, tcfg, torch.from_numpy(tok), ct, pol_t,
                               calib=tcal, backend=tb)
        np.testing.assert_allclose(t2n(lt), np.asarray(lj), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {step}")
    _compare_caches(ct, cj)


def test_identity_calib_matches_reference():
    cfg = configs.get_smoke("llama2_7b")
    want = JT.identity_calib(jconfigs.get_smoke("llama2_7b"), JPolicy(**KW))
    got = T.identity_calib(cfg, QuantPolicy(**KW), device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_params_scales_match_reference():
    """Same keys, shapes and per-leaf scale as the reference init (the
    draws themselves differ: torch.Generator is not jax.random)."""
    cfg = configs.get("llama2_7b").scaled(n_layers=2, d_model=256,
                                          n_heads=4, n_kv_heads=4,
                                          head_dim=64, d_ff=512,
                                          vocab_size=512)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = JT.init_params(jconfigs.get("llama2_7b").scaled(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512), jax.random.PRNGKey(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        std_t, std_j = float(node.std()), float(np.std(np.asarray(leaf)))
        assert abs(std_t - std_j) <= 0.05 * std_j + 1e-12, (path, std_t,
                                                            std_j)
