"""The port's encoder-decoder family (``seamless_m4t_large_v2``: LayerNorm
blocks, a bidirectional encoder over stub frame embeddings, and a
cross-attention cache quantized once under ``policy.without_window()``)
against the JAX reference, on the same seeded numpy inputs, at the SMOKE
shape, in f32.

The reference's params are drawn by ``jax.random`` once for the file and
carried over; the LayerNorm gains and biases (ones and zeros at init) are
replaced by seeded random values on both sides, so the norms are
exercised.  Backends are paired by dequant precision, as in
``tests/test_torch_model.py``: port ``"reference"`` with JAX
``"reference"``, port ``"cuda"`` (plain kernel versions on the CPU) with
JAX ``"pallas"`` (interpret mode).  The frames are drawn from a seeded
numpy generator, as the reference's frontend is a stub.

Tolerances, and why:
* the constant leaves of ``init_params`` (LayerNorm ``w`` ones, ``b`` and
  biases zeros): EXACT.
* ``layer_norm``: f32 ``atol = rtol = 1e-6`` (mean and variance summed in
  another order); bf16 equal to within one bf16 ulp of the output
  (``atol = rtol = 8e-3``), the f32 statistics rounded once.
* ``full_attention``: f32 ``atol = rtol = 1e-5`` (the same f32 scores,
  softmax and values summed in another order); a wrong mask, window or
  chunk moves rows by 1e-2 or more.
* ``_encode`` (two layers of the above plus the MLP): ``atol = rtol =
  1e-4``.
* logits, ``atol = rtol = 2e-4``; cache codes, the cross cache's
  included, at most 0.5% of packed bytes differing; fp sink/window values
  ``1e-5``; lengths exact: the bounds of ``tests/test_torch_moe.py``.
* ``collect_kv``: ``atol = rtol = 1e-4`` (``tests/test_torch_calibrate.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serving as jsv
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.policy import PAPER_POLICY, QuantPolicy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCH = "seamless_m4t_large_v2"
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3
LN_TOL = 1e-6
LN_BF16_TOL = 8e-3
ATTN_TOL = 1e-5
ENC_TOL = 1e-4
KV_TOL = 1e-4
MAX_LEN = 64                       # packed region of 52 tokens > window 8
DECODE_STEPS = 4


def _cfgs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _randomize_norms(tree, rng):
    """Every LayerNorm ``{w, b}`` replaced by seeded random values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"w", "b"}:
            out[k] = {"w": (1.0 + 0.2 * rng.normal(size=v["w"].shape)
                            ).astype(np.float32),
                      "b": (0.1 * rng.normal(size=v["b"].shape)
                            ).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _randomize_norms(v, rng)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def init_tree():
    """The reference's params as numpy, drawn once for the file."""
    return jax.tree.map(np.asarray, JT.init_params(
        jconfigs.get_smoke(ARCH), jax.random.PRNGKey(4)))


@pytest.fixture(scope="module")
def tree(init_tree):
    return _randomize_norms(init_tree, np.random.default_rng(40))


def _frames(cfg, b, seed, s=None):
    return np.random.default_rng(seed).normal(
        size=(b, s or cfg.enc_seq_len, cfg.d_model)).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# ------------------------------------------------------------ configs

def test_configs_equal_reference_field_by_field():
    for get in ("get", "get_smoke"):
        got = getattr(configs, get)(ARCH)
        want = getattr(jconfigs, get)(ARCH)
        assert got == ArchConfig(**{f: getattr(want, f) for f in
                                    ArchConfig.__dataclass_fields__}), get
        assert (got.family, got.norm, got.mlp_gated) == ("encdec", "layer",
                                                         False)
    assert configs.get("seamless-m4t-large-v2") == configs.get(ARCH)


def test_without_window_equals_reference():
    for kw in (KW, dict(KW, window=0, n_sink=0), {}):
        got, want = QuantPolicy(**kw).without_window(), \
            JPolicy(**kw).without_window()
        assert (got.window, got.n_sink, got.bits_k, got.bits_v,
                got.group_size) == (want.window, want.n_sink, want.bits_k,
                                    want.bits_v, want.group_size)
    bare = QuantPolicy(**dict(KW, window=0, n_sink=0))
    assert bare.without_window() is bare
    assert PAPER_POLICY.without_window().window == 0


def test_init_params_leaves_and_constants_equal_reference(init_tree):
    """The port's init holds the reference's leaves (``enc_layers``,
    ``enc_norm``, ``xattn``, ``norm_x``, LayerNorm ``{w, b}``) at their
    shapes, and its constant leaves bit for bit."""
    _, cfg = _cfgs()
    tp = T.init_params(cfg, seed=0, device="cpu")
    params_from_numpy(tree_to_numpy(tp), cfg, device="cpu")   # checks
    path = lambda p: "/".join(k.key for k in p)
    want = {path(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(init_tree)[0]}
    got = {path(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(tree_to_numpy(tp))[0]}
    assert {k: v.shape for k, v in want.items()} == T.param_shapes(cfg)
    for leaf in ("enc_layers/attn/wq", "enc_norm/b", "layers/xattn/wo_attn",
                 "layers/norm_x/w", "enc_layers/mlp/wi_up"):
        assert leaf in want
    assert "enc_layers/mlp/wi_gate" not in want
    const = [k for k, (_, init) in T.param_specs(cfg).items()
             if not isinstance(init, float) or init == 0]
    assert {"final_norm/w", "final_norm/b", "enc_norm/w",
            "layers/norm_x/b", "enc_layers/norm1/w"} <= set(const)
    for k in const:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="lack leaf 'enc_norm/b'"):
        params_from_numpy({**init_tree, "enc_norm": {
            "w": init_tree["enc_norm"]["w"]}}, cfg, device="cpu")


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_norm_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(2, 5, 64)) + 1.5).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=64)).astype(np.float32)
    b = (0.2 * rng.normal(size=64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = LN_TOL if dtype == "float32" else LN_BF16_TOL
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    jw, jb = jnp.asarray(w, jd), jnp.asarray(b, jd)
    tw, tb = torch.from_numpy(w).to(td), torch.from_numpy(b).to(td)
    want = JL.layer_norm(jx, jw, jb, 1e-6)
    got = TL.layer_norm(tx, tw, tb, 1e-6)
    assert got.dtype == td
    _close(got, np.asarray(want, np.float32), tol, "layer_norm")
    for norm in ("layer", "rms"):
        jcfg = jconfigs.get_smoke(ARCH).scaled(norm=norm)
        tcfg = configs.get_smoke(ARCH).scaled(norm=norm)
        _close(TL.norm(tx, {"w": tw, "b": tb}, tcfg),
               np.asarray(JL.norm(jx, {"w": jw, "b": jb}, jcfg), np.float32),
               tol, norm)


ATTN_CASES = {
    "causal": dict(),
    "windowed": dict(window=5),
    "bidirectional": dict(bidirectional=True),
    "cross": dict(bidirectional=True, sk=48),
    "q_chunked": dict(q_chunk=8),
    "q_chunked_ragged": dict(q_chunk=8, sq=36),
    "q_chunked_1024": dict(sq=2048, sk=2048, bidirectional=True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_full_attention_matches_reference(case):
    """GQA (4 query heads over 2 kv heads); the chunked cases run the
    reference's scan over query chunks where it divides, its single block
    where it does not ("ragged"), against the port's chunk loop."""
    kw = dict(ATTN_CASES[case])
    sq, sk = kw.pop("sq", 32), kw.pop("sk", None)
    sk = sk or sq
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    jcfg, cfg = _cfgs()
    jkw = dict(kw)
    if "window" in jkw:
        jkw["window"] = jnp.int32(jkw["window"])
    want = JA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jcfg, **jkw)
    got = TA.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), cfg, **kw)
    _close(got, want, ATTN_TOL, case)


def test_encoder_matches_reference(tree):
    jcfg, cfg = _cfgs()
    x = _frames(cfg, 2, 9)
    want = JT._encode(jax.tree.map(jnp.asarray, tree), jcfg,
                      {"enc_embeds": jnp.asarray(x)})
    tp = params_from_numpy(tree, cfg, device="cpu")
    _close(T._encode(tp, cfg, torch.from_numpy(x)), want, ENC_TOL)
    with pytest.raises(ValueError, match="pass enc_embeds"):
        T.prefill_model(tp, cfg, torch.zeros((1, 4), dtype=torch.int64),
                        QuantPolicy(**KW), backend="reference")


# ------------------------------------------------------------ model parity

@pytest.fixture(scope="module")
def reference_runs(tree):
    """``get(jb)``: the JAX prefill (2 x 37 tokens over 2 x enc_seq_len
    frames) and DECODE_STEPS decode steps (jitted), run once for the
    file: the inputs, the prefill's (logits, caches) and each step's."""
    runs = {}
    jcfg, _ = _cfgs()
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    frames = _frames(jcfg, 2, 13)
    steps = [rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]

    def get(jb):
        if jb not in runs:
            prefill = jax.jit(functools.partial(
                JT.prefill_model, cfg=jcfg, policy=JPolicy(**KW),
                max_len=MAX_LEN, backend=jb))
            step = jax.jit(functools.partial(
                JT.decode_step, cfg=jcfg, policy=JPolicy(**KW), backend=jb))
            out = [prefill(jp, batch={"tokens": jnp.asarray(toks),
                                      "enc_embeds": jnp.asarray(frames)})]
            for tok in steps:
                out.append(step(jp, token=jnp.asarray(tok),
                                caches=out[-1][1]))
            runs[jb] = out
        return toks, frames, steps, runs[jb]
    return get


def _as_port(cj):
    return {"scan": {k: torch.from_numpy(np.asarray(v).copy())
                     for k, v in cj["scan"].items()}}


def _compare_caches(ct, cj):
    want_all = jax.tree.map(np.asarray, cj)["scan"]
    assert sorted(ct["scan"]) == sorted(want_all)
    assert any(k.startswith("x_qk_") for k in want_all)
    assert not any(k.startswith(("x_sink", "x_win")) for k in want_all)
    for k, want in want_all.items():
        got = ct["scan"][k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k.endswith("length"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k.startswith(("sink_", "win_")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            rate = float(np.mean(got != want))
            assert rate <= FLIP_RATE, (k, rate)


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(tb, jb, tree, reference_runs):
    """Prefill 2 x 37 tokens over the frames (self cache and the
    window-0, sink-0 cross cache), then DECODE_STEPS steps from the
    reference's caches: logits each step; caches after the prefill and
    the last step, where the cross cache is what the prefill built (never
    appended to) and the self cache has grown."""
    _, cfg = _cfgs()
    toks, frames, steps, out = reference_runs(jb)
    tp = params_from_numpy(tree, cfg, device="cpu")
    lt, ct = T.prefill_model(tp, cfg, torch.from_numpy(toks),
                             QuantPolicy(**KW), max_len=MAX_LEN, backend=tb,
                             enc_embeds=torch.from_numpy(frames))
    _close(lt, out[0][0], LOGIT_TOL, "prefill")
    _compare_caches(ct, out[0][1])
    assert (ct["scan"]["x_length"] == cfg.enc_seq_len).all()
    ct = _as_port(out[0][1])
    cross = {k: v.clone() for k, v in ct["scan"].items()
             if k.startswith("x_")}
    for i, tok in enumerate(steps):
        lt, ct = T.decode_step(tp, cfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), backend=tb)
        _close(lt, out[i + 1][0], LOGIT_TOL, f"step {i}")
    _compare_caches(ct, out[-1][1])
    for k, v in cross.items():
        assert torch.equal(ct["scan"][k], v), k
    assert (ct["scan"]["length"] == 37 + DECODE_STEPS).all()


def test_collect_kv_matches_reference(tree):
    """The decoder's self-attention K/V of every layer, the encoder run
    first (the reference runs ``full_attention``, the port the prefill's
    block loop: within 1e-4)."""
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 40))
    frames = _frames(cfg, 3, 8)
    jk, jv = JT.collect_kv(jax.tree.map(jnp.asarray, tree), jcfg,
                           {"tokens": jnp.asarray(toks, jnp.int32),
                            "enc_embeds": jnp.asarray(frames)},
                           max_samples=100)
    tp = params_from_numpy(tree, cfg, device="cpu")
    tk, tv = T.collect_kv(tp, cfg, torch.from_numpy(toks), max_samples=100,
                          enc_embeds=torch.from_numpy(frames))
    assert tk.shape == (cfg.n_layers, 100, cfg.n_kv_heads, cfg.head_dim)
    _close(tk, jk, KV_TOL, "k")
    _close(tv, jv, KV_TOL, "v")
    with pytest.raises(ValueError, match="enc_embeds is for"):
        T.collect_kv(params_from_numpy(
            jax.tree.map(np.asarray, JT.init_params(
                jconfigs.get_smoke("llama3p2_1b"), jax.random.PRNGKey(0))),
            device="cpu"), configs.get_smoke("llama3p2_1b"),
            torch.from_numpy(toks), enc_embeds=torch.from_numpy(frames))


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("what", ["pool", "chunk"])
def test_pool_and_chunk_refusals_equal_reference(what, tree):
    """Pool and chunk refuse the encdec family at build time, with the
    reference's messages (the port's Engine checks its options before
    its own refusal of the family)."""
    jcfg, cfg = _cfgs()
    kw = (dict(pool_blocks=40, pool_block_tokens=8) if what == "pool"
          else dict(prefill_chunk=8))
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jsv.Engine(jax.tree.map(jnp.asarray, tree), jcfg, JPolicy(**KW),
                   batch_slots=2, max_len=52, **kw)
    tp = params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(want.type) as got:
        tsv.Engine(tp, cfg, QuantPolicy(**KW), batch_slots=2, max_len=52,
                   device="cpu", **kw)
    assert str(got.value) == str(want.value)
    if what == "chunk":
        with pytest.raises(NotImplementedError, match="ssm/hybrid/encdec"):
            T.prefill_chunk_init(cfg, QuantPolicy(**KW), 52, 52,
                                 device="cpu")


def test_engine_refuses_encdec(tree):
    """The port's Engine refuses the family at construction; the
    reference Engine takes it and fails inside its encoder at the first
    admission, as a Request carries no frames."""
    jcfg, cfg = _cfgs()
    tp = params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="family='encdec'"):
        tsv.Engine(tp, cfg, QuantPolicy(**KW), batch_slots=2, max_len=52,
                   device="cpu")
    eng = jsv.Engine(jax.tree.map(jnp.asarray, tree), jcfg, JPolicy(**KW),
                     batch_slots=2, max_len=52, backend="reference")
    h = eng.submit(jsv.Request(prompt=np.arange(1, 9, dtype=np.int32),
                               max_new=2))
    with pytest.raises(KeyError, match="enc_embeds"):
        eng.run([h])


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_cli_exits_with_the_engine_refusal(arch, capsys):
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert "family='encdec'" in capsys.readouterr().err
