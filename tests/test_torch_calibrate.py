"""Offline calibration in the port (``repro_torch.core.reorder``,
``core.calibrate``, ``core.quant.fake_quant``, ``transformer.collect_kv``
and ``fuse_v_permutation``) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances, and why:

* The reorder statistics and the k-means are the reference's numpy code,
  so features, labels and permutations are EXACT, and so are the weight
  fusions (pure gathers, compared by bit pattern on f32).
* ``fake_quant``: atol 1e-6 on f32 values, and the codes underneath are
  EXACT (``quantize_groups`` is byte-exact; the dequant ``q * h + lo`` is
  the same two f32 operations on both sides).
* Clip factors: equal.  The grid errors are f32 means that torch and XLA
  may sum in other orders, so a flip is tolerated only where the
  reference's two best grid errors lie within 1e-6 relative of each
  other; flips are counted, and the count is asserted 0 on these seeds.
* ``collect_kv``: atol = rtol = 1e-4 in f32 (torch and XLA sum matmuls in
  other orders; a wrong RoPE, norm or layer order moves K/V by 1e-2 or
  more).  Fused-V logits against unfused: atol = rtol = 2e-4, the bound
  tests/test_torch_model.py uses for f32 logits (the fused run sums the
  output projection's products in another order).
* End to end on the trained smoke model: tables from the reference's
  collected K/V EXACT; tables from the port's own ``collect_kv`` reported
  (their K/V differ in the last bits) with the NLL of a teacher-forced
  decode within 0.01 nats of the run on the reference's table.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import calibrate as JC
from repro.core import reorder as jro
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import fake_quant as j_fake_quant, n_meta_groups
from repro.core.quant import quantize_groups as j_quantize
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.convert import calib_from_numpy, params_from_numpy
from repro_torch.core import calibrate as TC
from repro_torch.core import reorder as tro
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import fake_quant, quantize_groups
from repro_torch.models import transformer as T
from test_torch_util import assert_tree_exact, bits_of
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

FQ_ATOL = 1e-6
TIE_REL = 1e-6
KV_TOL = 1e-4
LOGIT_TOL = 2e-4
NLL_TOL = 0.01


def _structured(rng, n=512, h=2, d=64, outliers=3):
    """K/V-like samples: per-channel log-normal scales and a few outlier
    channels (tests/test_calibrate.py's generator)."""
    x = rng.normal(size=(n, h, d))
    scales = np.exp(rng.normal(size=(1, h, d)))
    scales[..., :outliers] *= 30
    return (x * scales).astype(np.float32)


def _pols(**kw):
    return JPolicy(**kw), QuantPolicy(**kw)


# ------------------------------------------------------------------ reorder

@pytest.mark.parametrize("h,d", [(2, 64), (4, 128)])
def test_channel_features_and_kmeans_exact(h, d):
    rng = np.random.default_rng(h * d)
    x = _structured(rng, n=256, h=h, d=d)
    feats = tro.channel_features(x)
    np.testing.assert_array_equal(feats, jro.channel_features(x))
    for k in (1, 2, 4, 8):
        for seed in (0, 5):
            np.testing.assert_array_equal(
                tro.kmeans(feats[0], k, seed=seed),
                jro.kmeans(feats[0], k, seed=seed))
            got = tro.head_permutation(feats[1], k, seed=seed)
            want = jro.head_permutation(feats[1], k, seed=seed)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gs", [16, 32, 64, 128])
@pytest.mark.parametrize("h,d", [(2, 64), (3, 128), (4, 64)])
def test_compute_permutations_exact(h, d, gs):
    rng = np.random.default_rng(gs + h)
    x = _structured(rng, n=256, h=h, d=d)
    for seed in (0, 977):
        got = tro.compute_permutations(x, gs, seed=seed)
        want = jro.compute_permutations(x, gs, seed=seed)
        assert got.shape == (h, d) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert all(sorted(p) == list(range(d)) for p in got.tolist())


def test_invert_expand_and_smooth_exact(rng):
    perm = np.stack([rng.permutation(16) for _ in range(2)]).astype(np.int32)
    np.testing.assert_array_equal(tro.invert_permutation(perm),
                                  jro.invert_permutation(perm))
    np.testing.assert_array_equal(tro.expand_kv_perm_for_q(perm, 8),
                                  jro.expand_kv_perm_for_q(perm, 8))
    x = _structured(rng, n=128, h=2, d=16)
    for a in (1.0, 0.5):
        got, want = tro.smooth_factors(x, a), jro.smooth_factors(x, a)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stacked", [False, True])
def test_fuse_channels_bitwise(stacked, rng):
    d_model, h, hd, n_l = 24, 2, 8, 3
    lead = (n_l,) if stacked else ()
    w_out = rng.normal(size=lead + (d_model, h * hd)).astype(np.float32)
    w_in = rng.normal(size=lead + (h * hd, d_model)).astype(np.float32)
    perms = np.stack([np.stack([rng.permutation(hd) for _ in range(h)])
                      for _ in range(n_l)]).astype(np.int32)
    got_out = tro.fuse_out_channels(torch.from_numpy(w_out),
                                    perms if stacked else perms[0])
    got_in = tro.fuse_in_channels(torch.from_numpy(w_in),
                                  perms if stacked else perms[0])
    for i in range(n_l if stacked else 1):
        sel = (i,) if stacked else ()
        want_out = jro.fuse_out_channels(jnp.asarray(w_out[sel]), perms[i])
        want_in = jro.fuse_in_channels(jnp.asarray(w_in[sel]), perms[i])
        np.testing.assert_array_equal(bits_of(got_out[sel].numpy()),
                                      bits_of(want_out))
        np.testing.assert_array_equal(bits_of(got_in[sel].numpy()),
                                      bits_of(want_in))


# ---------------------------------------------------------------- fake_quant

@pytest.mark.parametrize("alpha_kind", ["none", "scalar", "group"])
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("bits", [1.0, 1.5, 2.0, 3.0, 4.0, 8.0, 16.0])
def test_fake_quant_equals_jax(bits, axis, alpha_kind, rng):
    """(B, S, H, D) = (2, 32, 2, 64), group 16: along D (axis -1, clip
    factors per head and group) or along the tokens (axis 1, KIVI's keys,
    clip factors per group)."""
    x = (rng.normal(size=(2, 32, 2, 64))
         * np.exp(rng.normal(size=(1, 1, 2, 64)))).astype(np.float32)
    d = x.shape[axis]
    g = n_meta_groups(d, bits, 16) if bits < 16 else 1
    alpha = {"none": None, "scalar": np.float32(0.85),
             "group": rng.uniform(0.6, 1.0, (2, g) if axis == -1 else (g,)
                                  ).astype(np.float32)}[alpha_kind]
    xt = torch.from_numpy(x)
    at = None if alpha is None else torch.as_tensor(alpha)
    got = fake_quant(xt, bits, 16, alpha=at, axis=axis)
    if bits >= 16:
        assert got is xt
        return
    want = np.asarray(j_fake_quant(
        jnp.asarray(x), bits, 16,
        alpha=None if alpha is None else jnp.asarray(alpha), axis=axis))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FQ_ATOL)
    # the codes underneath, exact
    xm, xj = xt.movedim(axis, -1), jnp.moveaxis(jnp.asarray(x), axis, -1)
    assert_tree_exact(quantize_groups(xm, bits, 16, at),
                      j_quantize(xj, bits, 16, None if alpha is None
                                 else jnp.asarray(alpha)), "codes")


def test_fake_quant_takes_a_quant_fn(rng):
    """``quant_fn`` replaces the quantizer: the kernel route's host side
    (plain version on the CPU) gives the same values, and a custom one is
    called with the reference's argument order."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_kernel_quant_fn
    x = torch.from_numpy(_structured(rng, n=64, h=2, d=64))
    alpha = torch.as_tensor(rng.uniform(0.6, 1.0, (2, 3)).astype(np.float32))
    reset_launch_counts()
    got = fake_quant(x, 1.5, 32, alpha=alpha,
                     quant_fn=make_kernel_quant_fn())
    assert launch_counts()["kv_quant"]["plain"] == 1
    assert torch.equal(got, fake_quant(x, 1.5, 32, alpha=alpha))
    seen = []

    def spy(*args):
        seen.append(args[1:])
        return quantize_groups(*args)
    fake_quant(x, 2.0, 32, quant_fn=spy)
    assert seen == [(2.0, 32, None, True)]


# --------------------------------------------------------------- calibration

def _ref_grid_errors(x, bits, gs, fp8_meta):
    """The reference's per-group reconstruction errors at every grid point
    (A, H, G), for the near-tie test of a flipped clip factor."""
    from repro.core.quant import plane_layout
    xj = jnp.asarray(x, jnp.float32)
    n, h, d = xj.shape
    out = []
    for a in JC.ALPHA_GRID:
        xq = j_fake_quant(xj, bits, gs, alpha=jnp.float32(a),
                          fp8_meta=fp8_meta)
        parts = [((xq[..., s:s + w] - xj[..., s:s + w]) ** 2)
                 .reshape(n, h, w // g, g).mean(axis=(0, 3))
                 for (s, w, _, g) in plane_layout(d, bits, gs)]
        out.append(np.asarray(jnp.concatenate(parts, axis=-1)))
    return np.stack(out)


def _count_alpha_flips(got, want, samples, perm, bits, gs, fp8_meta):
    """Number of clip factors that differ; each one must sit on a near-tie
    of the reference's grid errors, else the search is wrong."""
    bad = np.argwhere(got != want)
    if bad.size == 0:
        return 0
    x = np.take_along_axis(samples, perm[None], axis=2)
    errs = _ref_grid_errors(x, bits, gs, fp8_meta)
    for hh, gg in bad:
        two = np.sort(errs[:, hh, gg])[:2]
        assert two[1] - two[0] <= TIE_REL * abs(two[0]), \
            (f"alpha flip off a near-tie at head {hh} group {gg}: "
             f"{got[hh, gg]} vs {want[hh, gg]}, errors {two}")
    return len(bad)


def _assert_tables_equal(ct, cj, k, v, pol):
    gs = min(pol.group_size, k.shape[-1])
    for f in ("perm_k", "perm_v", "smooth_k"):
        a, b = getattr(ct, f), getattr(cj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    flips = 0
    for f, x, perm, bits in (("alpha_k", k, cj.perm_k, pol.bits_k),
                             ("alpha_v", v, cj.perm_v, pol.bits_v)):
        a, b = getattr(ct, f), getattr(cj, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        flips += _count_alpha_flips(a, b, x, perm, bits, gs, pol.fp8_meta)
    assert flips == 0, f"{flips} clip factors flipped on near-ties"


@pytest.mark.parametrize("gs,d,bits_v,reorder,clip", [
    (16, 64, 1.5, True, True), (16, 64, 1.5, True, False),
    (16, 64, 1.5, False, True), (16, 64, 1.5, False, False),
    (32, 64, 2.0, True, True), (32, 64, 2.0, False, True),
    (128, 128, 1.5, True, True)])
def test_calibrate_layer_equals_jax(gs, d, bits_v, reorder, clip):
    rng = np.random.default_rng(gs + d)
    k, v = _structured(rng, d=d), _structured(rng, d=d)
    jp, tp = _pols(bits_k=2.0, bits_v=bits_v, group_size=gs, window=8,
                   n_sink=2, reorder=reorder, clip=clip)
    cj = JC.calibrate_layer(k, v, jp, seed=3)
    ct = TC.calibrate_layer(torch.from_numpy(k), torch.from_numpy(v), tp,
                            seed=3)
    _assert_tables_equal(ct, cj, k, v, tp)
    # numpy samples are accepted as they are (the CPU route)
    cn = TC.calibrate_layer(k, v, tp, seed=3)
    for f in ("perm_k", "perm_v", "alpha_k", "alpha_v"):
        np.testing.assert_array_equal(getattr(cn, f), getattr(ct, f))


def test_calibrate_model_and_stacked_equal_jax():
    rng = np.random.default_rng(11)
    n_l, h, d = 3, 2, 64
    ks = np.stack([_structured(rng, n=256, h=h, d=d) for _ in range(n_l)])
    vs = np.stack([_structured(rng, n=256, h=h, d=d) for _ in range(n_l)])
    jp, tp = _pols(bits_k=2.0, bits_v=1.5, group_size=32, window=8, n_sink=2)
    cj = JC.calibrate_model(lambda: (ks, vs), jp, seed=5)
    ct = TC.calibrate_model(lambda: (torch.from_numpy(ks),
                                     torch.from_numpy(vs)), tp, seed=5)
    for l in range(n_l):
        _assert_tables_equal(ct.layers[l], cj.layers[l], ks[l], vs[l], tp)
    got = ct.stacked(device="cpu")
    want = calib_from_numpy(jax.tree.map(np.asarray, cj.stacked()),
                            device="cpu")
    ident = T.identity_calib(configs.get_smoke("llama2_7b").scaled(
        n_layers=n_l, n_kv_heads=h, head_dim=d), tp, device="cpu")
    assert sorted(got) == sorted(want) == sorted(ident)
    for key in got:
        assert got[key].dtype == want[key].dtype == ident[key].dtype, key
        assert got[key].shape == want[key].shape == ident[key].shape, key
        assert torch.equal(got[key], want[key]), key


def test_refine_attention_mse_equal_multiplier():
    rng = np.random.default_rng(4)
    b, s, h, d = 1, 32, 2, 64
    jp, tp = _pols(bits_k=2.0, bits_v=1.5, group_size=32, window=8, n_sink=2)
    for trial in range(2):
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        k = _structured(rng, n=s, h=h, d=d)[None]
        v = (rng.normal(size=(b, s, h, d)) * (1 + trial)).astype(np.float32)
        cal = JC.calibrate_layer(k[0], v[0], jp)
        want = JC.refine_attention_mse(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), cal, jp)
        got = TC.refine_attention_mse(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), cal, tp)
        assert got == want and got in (0.85, 0.9, 0.95, 1.0)


def test_alpha_grid_and_quant_fn_resolution():
    assert TC.ALPHA_GRID == JC.ALPHA_GRID and len(TC.ALPHA_GRID) == 11
    assert TC.resolve_quant_fn(None, "cpu") is quantize_groups
    spy = lambda *a: quantize_groups(*a)
    assert TC.resolve_quant_fn(spy, "cpu") is spy


# ------------------------------------------------------- collect_kv / fusion

def _converted(arch, seed):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["llama3p2_1b", "granite_8b"])
def test_collect_kv_equals_jax(arch, rng):
    jcfg, tcfg, jp, tp = _converted(arch, 1)
    toks = rng.integers(0, tcfg.vocab_size, (3, 40)).astype(np.int32)
    jk, jv = JT.collect_kv(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           max_samples=100)
    tk, tv = T.collect_kv(tp, tcfg, torch.from_numpy(toks).long(),
                          max_samples=100)
    assert tk.shape == tv.shape == (tcfg.n_layers, 100, tcfg.n_kv_heads,
                                    tcfg.head_dim)
    assert tk.dtype == torch.float32
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=KV_TOL,
                               rtol=KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=KV_TOL,
                               rtol=KV_TOL)
    # no cut below B x S; the params' dtype; the rows are (b, s)-major
    full, _ = T.collect_kv(tp, tcfg, torch.from_numpy(toks).long())
    assert full.shape[1] == 3 * 40 and torch.equal(full[:, :100], tk)
    half = T.collect_kv(T._cast_params(tp, torch.bfloat16), tcfg,
                        torch.from_numpy(toks).long())[0]
    assert half.dtype == torch.bfloat16


def test_collect_kv_refuses_a_non_dense_config():
    cfg = configs.get_smoke("llama3p2_1b")
    p = T.init_params(cfg, seed=0, device="cpu")
    for fam in ("ssm",):             # attention-free: no KV cache at all
        with pytest.raises(ValueError, match="rwkv6 has no KV cache"):
            T.collect_kv(p, cfg.scaled(family=fam),
                         torch.zeros((1, 8), dtype=torch.long))


def test_fuse_v_permutation_equals_jax(rng):
    jcfg, tcfg, jp, tp = _converted("llama3p2_1b", 2)
    hkv, hd = tcfg.n_kv_heads, tcfg.head_dim
    perms = np.stack([np.stack([rng.permutation(hd) for _ in range(hkv)])
                      for _ in range(tcfg.n_layers)]).astype(np.int32)
    fused = T.fuse_v_permutation(tp["layers"]["attn"], perms, tcfg.n_heads)
    assert sorted(fused) == sorted(tp["layers"]["attn"])
    for l in range(tcfg.n_layers):
        jattn = jax.tree.map(lambda a: a[l], jp["layers"]["attn"])
        want = JT.fuse_v_permutation(jattn, perms[l], jcfg.n_heads)
        one = T.fuse_v_permutation({k: v[l] for k, v in
                                    tp["layers"]["attn"].items()},
                                   torch.from_numpy(perms[l]), tcfg.n_heads)
        for key in want:
            np.testing.assert_array_equal(bits_of(fused[key][l].numpy()),
                                          bits_of(want[key]), err_msg=key)
            assert torch.equal(one[key], fused[key][l]), key


def test_fused_weights_with_identity_perm_v_match_unfused(rng):
    """Prefill and decode logits of the port: fused weights served with an
    identity perm_v against the unfused weights with the calibrated one."""
    _, tcfg, _, tp = _converted("llama3p2_1b", 2)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 40))).long()
    cal = TC.calibrate_model(lambda: T.collect_kv(tp, tcfg, toks), pol,
                             seed=1).stacked(device="cpu")
    eye = T.identity_calib(tcfg, pol, device="cpu")["perm_v"]
    assert not torch.equal(cal["perm_v"], eye)
    fused = dict(tp, layers=dict(tp["layers"], attn=T.fuse_v_permutation(
        tp["layers"]["attn"], cal["perm_v"], tcfg.n_heads)))
    cal_f = dict(cal, perm_v=eye)
    runs = []
    for p, c in ((tp, cal), (fused, cal_f)):
        lg, caches = T.prefill_model(p, tcfg, toks[:, :32], pol, calib=c,
                                     max_len=48)
        out = [lg]
        for t in range(32, 40):
            lg, caches = T.decode_step(p, tcfg, toks[:, t:t + 1], caches,
                                       pol, calib=c)
            out.append(lg)
        runs.append(torch.cat(out, dim=1))
    np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ----------------------------------------------- end to end (trained model)

def _decode_nll(params, cfg, tokens, policy, calib=None, prefix=32):
    """Teacher-forced decode NLL over the suffix with the SKVQ cache
    (tests/test_system.py's ``_decode_nll``, through the port)."""
    logits, caches = T.prefill_model(params, cfg, tokens[:, :prefix], policy,
                                     calib=calib, max_len=tokens.shape[1] + 8)
    total, n = 0.0, 0
    for t in range(prefix, tokens.shape[1]):
        lf = logits.float()[:, -1]
        gold = lf.gather(-1, tokens[:, t, None])[..., 0]
        total += float((torch.logsumexp(lf, dim=-1) - gold).sum())
        n += int(tokens.shape[0])
        logits, caches = T.decode_step(params, cfg, tokens[:, t:t + 1],
                                       caches, policy, calib=calib)
    return total / n


def test_end_to_end_on_the_trained_model(tiny_trained):
    """train (JAX) -> convert -> calibrate in the port -> SKVQ decode in
    the port; the ordering of test_system.py::test_skvq_end_to_end_quality
    (calibrated SKVQ beats RTN without a window, close to 8-bit).  Every
    policy of that test runs in the port, the no-window RTN included."""
    jcfg, corpus = tiny_trained["cfg"], tiny_trained["corpus"]
    cfg = configs.get_smoke("llama3p2_1b")
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            tiny_trained["params"]),
                               cfg, device="cpu")
    toks = np.stack([corpus.sample(64, np.random.default_rng(i))
                     for i in range(8)]).astype(np.int32)
    calib_toks = np.stack([corpus.sample(64, np.random.default_rng(100 + i))
                           for i in range(8)]).astype(np.int32)
    kw = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=16, n_sink=2)
    jp, tp = _pols(**kw)

    jk, jv = JT.collect_kv(tiny_trained["params"], jcfg,
                           {"tokens": jnp.asarray(calib_toks)})
    jk, jv = np.array(jk), np.array(jv)
    ref = JC.Calibration([JC.calibrate_layer(jk[l], jv[l], jp)
                          for l in range(jk.shape[0])])
    # the reference's samples -> the reference's tables, exactly
    same = TC.calibrate_model(lambda: (torch.from_numpy(jk),
                                       torch.from_numpy(jv)), tp)
    for l in range(cfg.n_layers):
        _assert_tables_equal(same.layers[l], ref.layers[l], jk[l], jv[l], tp)
    ref_table = calib_from_numpy(jax.tree.map(np.asarray, ref.stacked()),
                                 device="cpu")

    # the port's own samples -> its own tables (reported), same quality
    tk, tv = T.collect_kv(params, cfg, torch.from_numpy(calib_toks).long())
    np.testing.assert_allclose(tk.numpy(), jk, atol=KV_TOL, rtol=KV_TOL)
    own = TC.calibrate_model(lambda: (tk, tv), tp).stacked(device="cpu")
    differ = {k: int((own[k] != ref_table[k]).sum()) for k in own}
    ttoks = torch.from_numpy(toks).long()
    nll_own = _decode_nll(params, cfg, ttoks, tp, calib=own)
    nll_ref = _decode_nll(params, cfg, ttoks, tp, calib=ref_table)
    assert abs(nll_own - nll_ref) <= NLL_TOL, (nll_own, nll_ref, differ)

    nll_hi = _decode_nll(params, cfg, ttoks, QuantPolicy(
        bits_k=8.0, bits_v=8.0, group_size=16, window=16, n_sink=2,
        fp8_meta=False))
    nll_rtn = _decode_nll(params, cfg, ttoks, QuantPolicy(
        bits_k=2.0, bits_v=1.5, group_size=16, window=0, n_sink=0,
        clip=False, reorder=False))
    assert nll_own < nll_rtn, (nll_own, nll_rtn)
    assert nll_own - nll_hi < 0.75 * (nll_rtn - nll_hi) + 0.02, \
        (nll_hi, nll_own, nll_rtn, differ)
