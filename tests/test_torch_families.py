"""The port's gemma local/global family (``gemma2_27b``, ``gemma3_4b``)
against the JAX reference, on the same seeded numpy inputs, at the SMOKE
shapes, in f32.  qwen2-vl's M-RoPE decoder (``qwen2_vl_7b``) has its own
file, ``tests/test_torch_vlm.py``, which shares this file's helpers and
tolerances.

The reference's params are drawn by ``jax.random`` and carried over; their
zero-initialised ``q_norm``/``k_norm`` and qkv biases are replaced by seeded
random values on both sides, so the norms and biases are exercised.  The
calibration is NOT identity (random channel permutations, clip factors
alpha in [0.8, 1]).  Backends are paired by dequant precision, as in
``tests/test_torch_model.py``: port ``"reference"`` with JAX
``"reference"``, port ``"cuda"`` (plain kernel versions on the CPU) with
JAX ``"pallas"`` (interpret mode).

Tolerances, and why:
* logits, ``atol = rtol = 2e-4`` — the same f32 math summed in another
  order by torch and XLA (~1e-6 relative per op), compounded over up to
  six layers and the unembedding; a wrong mask, window, RoPE base,
  M-RoPE band, norm, bias or softcap moves logits by 1e-2 or more.  The
  unrolled step is held to the same bound against JAX's unrolled step and
  against the port's own default step: at these shapes the policy window
  (8) equals the local window (8), so the one token the pre-append
  protocol keeps in fp instead of quantized lies outside every local
  layer's band and both orders attend the same tokens.  With a policy
  window of 4 the orders differ, and a pooled band (append first) is held
  only against JAX's pooled unrolled step, at the same bound.
* cache codes: at most 0.5% of packed bytes may differ (a K/V value one
  ulp off can cross a rounding edge and flip one code); fp sink/window
  values ``atol = rtol = 1e-5``; lengths exact.
* single decode attentions with the levers, f32 with identical inputs:
  ``atol = 3e-5, rtol = 1e-4`` (``tests/test_torch_kernels.py``'s
  decode_attn tolerance: the same sums in another order).
* greedy token streams of the Engines: equal, token for token.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import kv_cache as jkvc
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.quant import n_meta_groups
from repro.kernels.ops import pallas_decode_attention
from repro.models import attention as JA
from repro.models import transformer as JT
from repro import serving as jsv

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import (calib_from_numpy, params_from_numpy,
                                 tree_to_numpy)
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from test_torch_util import j2t, t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCHS = ["gemma2_27b", "gemma3_4b"]
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3
ATOL, RTOL = 3e-5, 1e-4
MAX_LEN = 64                       # packed region of 52 tokens > window 8


def _np_params(jcfg, seed, rng):
    """Reference params as numpy, with random q/k norms and qkv biases."""
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    attn = tree["layers"]["attn"]
    for k in ("q_norm", "k_norm", "bq", "bk", "bv"):
        if k in attn:
            attn[k] = rng.normal(0.0, 0.3, attn[k].shape).astype(np.float32)
    return tree


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
    tree = _np_params(jcfg, 3, rng)
    cal = _calib(jcfg, rng)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"),
            {k: jnp.asarray(v) for k, v in cal.items()},
            calib_from_numpy(cal, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jstep(jcfg, kw: tuple, jb: str, unroll: bool = False):
    """The reference's decode step for one (config, policy, backend,
    unroll), jitted once and shared by every step and case of the process
    (ROADMAP's CPU-budget lever 1): run eagerly, every step lowered its
    Pallas kernels anew.  ``kw`` is the policy's sorted items."""
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg,
                                     policy=JPolicy(**dict(kw)), backend=jb,
                                     unroll=unroll))


@functools.lru_cache(maxsize=None)
def _jprefill(jcfg, kw: tuple, jb: str):
    """The reference's prefill at ``MAX_LEN`` for one (config, policy,
    backend), jitted once (as :func:`_jstep`); called ``(params, batch,
    calib)``."""
    return jax.jit(lambda p, batch, calib: JT.prefill_model(
        p, jcfg, batch, JPolicy(**dict(kw)), calib=calib, max_len=MAX_LEN,
        backend=jb))


def _jdecode(jp, jcfg, tok, caches, kw, jcal, jb, unroll=False):
    """One reference decode step through :func:`_jstep`."""
    return _jstep(jcfg, tuple(sorted(kw.items())), jb, unroll)(
        jp, token=jnp.asarray(tok), caches=caches, calib=jcal)


def _close(got, want, what=""):
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg=what)


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


def _prefilled(arch, tb, jb, rng, kw=KW):
    jcfg, tcfg, jp, tp, jcal, tcal = _setup(arch, rng)
    toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    lj, cj = _jprefill(jcfg, tuple(sorted(kw.items())), jb)(
        jp, {"tokens": jnp.asarray(toks)}, jcal)
    lt, ct = T.prefill_model(tp, tcfg, torch.from_numpy(toks),
                             QuantPolicy(**kw), calib=tcal, max_len=MAX_LEN,
                             backend=tb)
    _close(lt, lj, "prefill")
    _compare_caches(ct, cj)
    return jcfg, tcfg, jp, tp, jcal, tcal, cj


# ------------------------------------------------------------ configs

def _check_configs(arch):
    for get in ("get", "get_smoke"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert got == ArchConfig(**{f: getattr(want, f) for f in
                                    ArchConfig.__dataclass_fields__}), get
    alias = {"gemma2_27b": "gemma2-27b", "gemma3_4b": "gemma3-4b",
             "qwen2_vl_7b": "qwen2-vl-7b"}[arch]
    assert configs.get(alias) == configs.get(arch)


def _check_init_leaves(arch):
    """The port's init holds the reference's leaves (q/k norms, biases,
    lm_head as the config asks) at their shapes; the conversion checks
    that tree against the config."""
    cfg = configs.get_smoke(arch)
    tp = T.init_params(cfg, seed=0, device="cpu")
    jp = jax.tree.map(np.asarray, JT.init_params(jconfigs.get_smoke(arch),
                                                 jax.random.PRNGKey(0)))
    params_from_numpy(tree_to_numpy(tp), cfg, device="cpu")   # checks
    flat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat == T.param_shapes(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    _check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaves_equal_reference(arch):
    _check_init_leaves(arch)


# ------------------------------------------------------------ model parity

def _check_prefill_decode(arch, tb, jb, rng):
    """Prefill 37 tokens, then 6 decode steps (positions 37-42, all past
    the local window of 8)."""
    jcfg, tcfg, jp, tp, jcal, tcal, cj = _prefilled(arch, tb, jb, rng)
    ct = j2t(cj)
    for step in range(6):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = _jdecode(jp, jcfg, tok, cj, KW, jcal, jb)
        lt, ct = T.decode_step(tp, tcfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), calib=tcal, backend=tb)
        _close(lt, lj, f"step {step}")
    _compare_caches(ct, cj)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(arch, tb, jb, rng):
    _check_prefill_decode(arch, tb, jb, rng)


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_unrolled_step_matches_reference_and_default(tb, jb, rng):
    """gemma3 smoke: 5 of 6 layers local, 52 packed slots > the local
    window 8, so every step takes the hoist and the pre-append order."""
    jcfg, tcfg, jp, tp, jcal, tcal, cj = _prefilled("gemma3_4b", tb, jb,
                                                    rng)
    group = j2t(cj)["scan"]
    hoist = T._local_hoist(tcfg, group, QuantPolicy(**KW),
                           group["length"][0], 0, tcfg.n_layers)
    assert hoist is not None and hoist[2].shape == (2, tcfg.local_window)
    ct, cd = j2t(cj), j2t(cj)
    for step in range(4):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = _jdecode(jp, jcfg, tok, cj, KW, jcal, jb, unroll=True)
        lt, ct = T.decode_step(tp, tcfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), calib=tcal, backend=tb,
                               unroll=True)
        ld, cd = T.decode_step(tp, tcfg, torch.from_numpy(tok), cd,
                               QuantPolicy(**KW), calib=tcal, backend=tb)
        _close(lt, lj, f"unrolled vs JAX unrolled, step {step}")
        _close(lt, t2n(ld), f"unrolled vs default, step {step}")
    _compare_caches(ct, cj)


def _pooled(caches, block_tokens=4):
    """A layer-stacked striped cache group -> the same tokens in a pooled
    group: slot b's logical block lb at physical block 1 + b * NB + lb."""
    g = caches["scan"]
    n, b, s = g["qk_codes_hi"].shape[:3]
    nb = s // block_tokens
    out = {}
    for k, v in g.items():
        if k.startswith(("qk_", "qv_")):
            blocks = v.reshape(n, b * nb, block_tokens, *v.shape[3:])
            null = torch.zeros_like(blocks[:, :1])
            out[k] = torch.cat([null, blocks], dim=1)
        else:
            out[k] = v.clone()
    tbl = 1 + torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    out["block_tbl"] = tbl.expand(n, b, nb).contiguous()
    return {"scan": out}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_unrolled_pooled_band_skips_the_hoist(backend, rng):
    """A pooled band has no per-slot token axis: no hoist, its local
    layers attend after their append through ``local_slice`` over the
    gathered striped view.  Here the policy window (8) equals the local
    window (8), so that order and the striped band's pre-append order
    attend the same tokens and the logits equal the striped unrolled
    step's; below the local window they do not (next test)."""
    jcfg, tcfg, jp, tp, jcal, tcal, cj = _prefilled("gemma3_4b", backend,
                                                    "reference", rng)
    striped, pooled = j2t(cj), _pooled(j2t(cj))
    pol = QuantPolicy(**KW)
    assert T._local_hoist(tcfg, pooled["scan"], pol,
                          pooled["scan"]["length"][0], 0, 6) is None
    for step in range(3):
        tok = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (2, 1)))
        ls, striped = T.decode_step(tp, tcfg, tok, striped, pol, calib=tcal,
                                    backend=backend, unroll=True)
        lp, pooled = T.decode_step(tp, tcfg, tok, pooled, pol, calib=tcal,
                                   backend=backend, unroll=True)
        _close(lp, t2n(ls), f"step {step}")


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_unrolled_pooled_step_matches_reference_below_local_window(tb, jb,
                                                                   rng):
    """Policy window 4 < local window 8: a pooled band's unrolled step
    (append, then attend over ``local_slice``) against JAX's pooled
    unrolled step.  There the token each append evicts is read quantized,
    where a striped band's pre-append order still reads it in fp, so
    pooled and striped unrolled steps differ, in the reference as in the
    port (ROADMAP §3): the gap is asserted to show."""
    kw = dict(KW, window=4)
    jcfg, tcfg, jp, tp, jcal, tcal, cj = _prefilled("gemma3_4b", tb, jb,
                                                    rng, kw)
    striped, pooled = j2t(cj), _pooled(j2t(cj))
    pj = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      tree_to_numpy(pooled))
    gap = 0.0
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        lj, pj = _jdecode(jp, jcfg, tok, pj, kw, jcal, jb, unroll=True)
        lp, pooled = T.decode_step(tp, tcfg, torch.from_numpy(tok), pooled,
                                   QuantPolicy(**kw), calib=tcal,
                                   backend=tb, unroll=True)
        ls, striped = T.decode_step(tp, tcfg, torch.from_numpy(tok),
                                    striped, QuantPolicy(**kw), calib=tcal,
                                    backend=tb, unroll=True)
        _close(lp, lj, f"pooled unrolled vs JAX pooled unrolled, step {step}")
        gap = max(gap, float((lp - ls).abs().max()))
    _compare_caches(pooled, pj)
    assert gap > 10 * LOGIT_TOL, gap


# ------------------------------------------------------------ the levers

def _lever_cache(rng, pol_j):
    """Two slots of 40 and 29 tokens (max_len 64: 52 packed slots), then
    3 appends, as the JAX package builds them."""
    cache = jkvc.init_cache(2, MAX_LEN, 2, 16, pol_j, jnp.float32)
    for i, n in enumerate((40, 29)):
        kv = [jnp.asarray(rng.normal(size=(1, n, 2, 16)), jnp.float32)
              for _ in range(2)]
        cache = jkvc.insert_slot(cache, i, jkvc.prefill(*kv, MAX_LEN, pol_j))
    for _ in range(3):
        kn, vn = [jnp.asarray(rng.normal(size=(2, 1, 2, 16)), jnp.float32)
                  for _ in range(2)]
        cache = jkvc.decode_append(cache, kn, vn, pol_j)
    return cache


LEVERS = {"chunk_pruned": dict(chunk=4, prune_blocks=True),
          "chunk_full": dict(chunk=4, prune_blocks=False),
          "local_slice": dict(local_slice=8),
          "override": None}


@pytest.mark.parametrize("lever", sorted(LEVERS))
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_decode_levers_match_reference(lever, backend, rng):
    """One lever at a time on gemma2 smoke's attention (softcap 50, query
    scale 1/4) over a local window of 8: the reference backend against
    ``repro.models.attention.decode_attention_skvq``, the cuda route
    (plain kernel on the CPU) against ``pallas_decode_attention``."""
    cfg, jcfg = configs.get_smoke("gemma2_27b"), jconfigs.get_smoke(
        "gemma2_27b")
    pol_j, pol_t = JPolicy(**KW), QuantPolicy(**KW)
    cache = _lever_cache(rng, pol_j)
    q = jnp.asarray(rng.normal(size=(2, 1, 4, 16)), jnp.float32)
    kw = dict(LEVERS[lever] or {})
    jkw, tkw = dict(kw), dict(kw)
    if lever == "override":
        lens = jnp.asarray(cache["length"])
        qc = jnp.maximum(lens - KW["n_sink"] - KW["window"] + 1, 0)
        j = jnp.clip(qc - 8, 0, 52 - 8)[:, None] + jnp.arange(8)
        sl = lambda a: jnp.take_along_axis(a, j[:, :, None, None], axis=1)
        kq = {k[3:]: sl(v) for k, v in cache.items() if k.startswith("qk_")}
        vq = {k[3:]: sl(v) for k, v in cache.items() if k.startswith("qv_")}
        ex = [jnp.asarray(rng.normal(size=(2, 1, 2, 16)), jnp.float32)
              for _ in range(2)]
        jkw = dict(packed_override=(kq, vq, j), extra_kv=(*ex, lens),
                   q_pos=lens)
        tj = j2t({"j": j, "lens": lens, "k": ex[0], "v": ex[1]})
        tkw = dict(packed_override=(j2t(kq), j2t(vq), tj["j"]),
                   extra_kv=(tj["k"], tj["v"], tj["lens"]),
                   q_pos=tj["lens"])
    common = dict(window=8, dtype=jnp.float32)
    tq, tcache = j2t({"q": q})["q"], j2t(cache)
    if backend == "reference":
        want = JA.decode_attention_skvq(q, cache, jcfg, pol_j, **common,
                                        **jkw)
        got = TA.decode_attention_skvq(tq, tcache, cfg, pol_t, window=8,
                                       dtype=torch.float32, **tkw)
    else:
        scale = TA._scale(cfg)
        want = pallas_decode_attention(q, cache, pol_j, scale=scale,
                                       softcap=jcfg.attn_softcap,
                                       interpret=True, block_s=16,
                                       **common, **jkw)
        got = ops.cuda_decode_attention(tq, tcache, pol_t, scale=scale,
                                        softcap=cfg.attn_softcap, window=8,
                                        dtype=torch.float32, block_s=16,
                                        **tkw)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_dense_decode_functions_match_reference(rng):
    """``decode_attention`` (per-slot masks and positions, a local window
    and the softcap) and ``decode_attention_fp`` over a plain cache."""
    cfg, jcfg = configs.get_smoke("gemma2_27b"), jconfigs.get_smoke(
        "gemma2_27b")
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 20, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 20, 2, 16)).astype(np.float32)
    lens = np.asarray([20, 7, 13], np.int32)
    pos = np.arange(20, dtype=np.int32)
    valid = pos[None] < lens[:, None]
    for window in (None, 5):
        want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(valid), jnp.asarray(lens - 1),
                                   jcfg, window)
        got = TA.decode_attention(*map(torch.from_numpy, (q, k, v, pos,
                                                          valid, lens - 1)),
                                  cfg, window)
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        cache = {"k": k, "v": v, "length": lens}
        want = JA.decode_attention_fp(jnp.asarray(q), jax.tree.map(
            jnp.asarray, cache), jcfg, window)
        got = TA.decode_attention_fp(torch.from_numpy(q), {
            n: torch.from_numpy(a) for n, a in cache.items()}, cfg, window)
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


# ------------------------------------------------------------ conversion

def _check_convert(arch, rng):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    tree = _np_params(jcfg, 4, rng)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    attn = tp["layers"]["attn"]
    keys = {"q_norm", "k_norm"} if tcfg.qk_norm else {"bq", "bk", "bv"}
    assert keys <= set(attn)
    for k in keys:
        np.testing.assert_array_equal(attn[k].numpy(),
                                      tree["layers"]["attn"][k])
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    if "lm_head" in tp:
        np.testing.assert_array_equal(tp["lm_head"].numpy(), tree["lm_head"])
    missing = {**tree, "layers": {**tree["layers"], "attn": {
        k: v for k, v in tree["layers"]["attn"].items()
        if k not in ("k_norm", "bv")}}}
    lost = "k_norm" if tcfg.qk_norm else "bv"
    with pytest.raises(ValueError, match=f"lack leaf 'layers/attn/{lost}'"):
        params_from_numpy(missing, tcfg, device="cpu")
    extra = {**tree, "layers": {**tree["layers"], "attn": {
        **tree["layers"]["attn"], "bias_x": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="'layers/attn/bias_x'"):
        params_from_numpy(extra, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["gemma3_4b"])
def test_convert_carries_norms_biases_and_head(arch, rng):
    _check_convert(arch, rng)


# ------------------------------------------------------------ engines

class _JEngine(jsv.Engine):
    """The reference Engine with its activated chunked job's table row
    flushed (its known deviation, ``tests/test_torch_degradation.py``)."""

    def _finish_prefill(self, job, logits):
        super()._finish_prefill(job, logits)
        for pool in self._pools.values():
            pool.dirty = True


ENGINE_MODES = {"striped": {}, "pooled": dict(pool_blocks=40,
                                              pool_block_tokens=8),
                "chunked": dict(prefill_chunk=8),
                "pooled_chunked": dict(pool_blocks=40, pool_block_tokens=8,
                                       prefill_chunk=8)}


def _streams(eng, traffic, request):
    hs = [eng.submit(request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert all(h.finished for h in hs)
    return [list(h.tokens) for h in hs]


def _check_engine(arch, mode, rng):
    """Greedy streams of two waves on 2 slots (prompts 12-30, 6-13 new
    tokens: past the local window), the port's cuda backend against the
    reference Engine's reference backend."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    tree = _np_params(jcfg, 2, rng)
    traffic = [(rng.integers(0, jcfg.vocab_size, n).astype(np.int32), m)
               for n, m in zip((12, 20, 30, 7), (9, 6, 13, 8))]
    kw = dict(batch_slots=2, max_len=52, steps_per_sync=4,
              **ENGINE_MODES[mode])
    cls = _JEngine if mode == "pooled_chunked" else jsv.Engine
    want = _streams(cls(jax.tree.map(jnp.asarray, tree), jcfg,
                        JPolicy(**KW), backend="reference", **kw),
                    traffic, jsv.Request)
    got = _streams(tsv.Engine(params_from_numpy(tree, tcfg, device="cpu"),
                              tcfg, QuantPolicy(**KW), backend="cuda",
                              device="cpu", **kw), traffic, tsv.Request)
    assert got == want


@pytest.mark.parametrize("arch,mode", [("gemma3_4b", m) for m in
                                       ENGINE_MODES])
def test_engine_streams_equal_reference(arch, mode, rng):
    _check_engine(arch, mode, rng)


# ------------------------------------------------------------ CLI

def _check_cli(arch, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--requests", "3", "--prompt-len", "24",
                 "--new-tokens", "6", "--window", "8", "--sinks", "2",
                 "--group-size", "16"])
    out = capsys.readouterr().out
    name = configs.get(arch).name
    assert f"arch={name}" in out


@pytest.mark.parametrize("arch", ["gemma3_4b", "gemma2-27b"])
def test_cli_serves_the_new_archs_on_the_cpu(arch, capsys):
    _check_cli(arch, capsys)
