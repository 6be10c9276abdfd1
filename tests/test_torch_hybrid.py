"""The port's hybrid family (``hymba_1p5b``: attention + Mamba heads in
every block) against the JAX reference, on the same seeded numpy inputs, at
the SMOKE shape, in f32.

The reference's params are drawn by ``jax.random`` once for the file and
carried over with ``params_from_numpy``.  Backends are paired by dequant
precision, as in ``tests/test_torch_model.py``: port ``"reference"`` with
JAX ``"reference"``, port ``"cuda"`` (plain kernel versions on the CPU)
with JAX ``"pallas"`` (interpret mode).

Tolerances, and why:
* ``_conv_causal``: f32 ``atol = rtol = 1e-6`` (the same K products
  summed in the same order).
* ``_ssm_scan``, ``ssm_forward`` (output and the ``conv``/``h`` state) and
  ``ssm_decode``: f32 ``atol = rtol = 1e-5``.  The port scans by doubling
  (ceil(log2 S) passes), the reference by ``lax.associative_scan``: the
  same products and sums associated in another order, ~1e-7 relative a
  pass; a wrong step, decay or skip term moves h by 1e-2 or more.
* the constant leaves of ``init_params`` (``dt_bias`` -2, ``a_log``
  log(1..N), ``d_skip`` ones, zero biases and norms): EXACT.
* logits, ``atol = rtol = 2e-4``, cache codes at most 0.5% of packed
  bytes differing, fp sink/window values ``1e-5``, lengths exact: the
  bounds of ``tests/test_torch_moe.py``, for the same reasons; the SSM
  state leaves of the caches ``ssm_conv``/``ssm_h`` at the SSM bound
  above, 1e-5.
* ``collect_kv``: ``atol = rtol = 1e-4`` (``tests/test_torch_calibrate.py``).
* greedy token streams of the Engines: equal, token for token.
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
from repro.models import ssm as JS
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCH = "hymba_1p5b"
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3
CONV_TOL = 1e-6
SSM_TOL = 1e-5
KV_TOL = 1e-4
MAX_LEN = 64                       # packed region of 52 tokens > window 8
DECODE_STEPS = 4
SEQ_LENS = [1, 7, 64, 300]         # 7 and 300 are not powers of two


@pytest.fixture(scope="module")
def tree():
    """The reference's params as numpy, drawn once for the file."""
    return jax.tree.map(np.asarray, JT.init_params(
        jconfigs.get_smoke(ARCH), jax.random.PRNGKey(3)))


def _cfgs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _ssm_params(tree, layer=1):
    """One layer's Mamba head: (numpy for JAX, tensors for the port)."""
    p = {k: v[layer] for k, v in tree["layers"]["ssm"].items()}
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


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
        assert got.family == "hybrid" and got.ssm_state == want.ssm_state
    assert configs.get("hymba-1.5b") == configs.get(ARCH)
    full = configs.get(ARCH)
    assert [i for i in range(full.n_layers)
            if not full.layer_is_local(i)] == [0, 16, 31]


def test_init_params_leaves_and_constants_equal_reference(tree):
    """The port's init holds the reference's leaves at their shapes, and
    its constant leaves bit for bit; the conversion takes the reference's
    params and checks its own tree against the config."""
    _, cfg = _cfgs()
    tp = T.init_params(cfg, seed=0, device="cpu")
    params_from_numpy(tree_to_numpy(tp), cfg, device="cpu")   # checks
    flat = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {k: v.shape for k, v in flat.items()} == T.param_shapes(cfg)
    const = [k for k, (_, init) in T.param_specs(cfg).items()
             if not isinstance(init, float) or init == 0]
    assert {"layers/ssm/dt_bias", "layers/ssm/a_log", "layers/ssm/d_skip",
            "layers/ssm/conv_b", "layers/norm_attn_out/w",
            "layers/norm_ssm_out/w", "final_norm/w"} <= set(const)
    got = {"/".join(p.key for p in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(tree_to_numpy(tp))[0]}
    for k in const:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    conv = params_from_numpy(tree, cfg, device="cpu")
    np.testing.assert_array_equal(conv["layers"]["ssm"]["x_proj"],
                                  tree["layers"]["ssm"]["x_proj"])
    with pytest.raises(ValueError, match="lack leaf 'layers/ssm/a_log'"):
        params_from_numpy({**tree, "layers": {
            **tree["layers"], "ssm": {
                k: v for k, v in tree["layers"]["ssm"].items()
                if k != "a_log"}}}, cfg, device="cpu")


# ------------------------------------------------------------ ssm module

@pytest.mark.parametrize("s", SEQ_LENS)
def test_conv_causal_matches_reference(s, tree):
    jp, tp = _ssm_params(tree)
    x = np.random.default_rng(s).normal(
        size=(2, s, tp["conv_w"].shape[1])).astype(np.float32)
    want = JS._conv_causal(jnp.asarray(x), jnp.asarray(jp["conv_w"]))
    _close(TS._conv_causal(torch.from_numpy(x), tp["conv_w"]), want,
           CONV_TOL)


@pytest.mark.parametrize("s", SEQ_LENS)
def test_ssm_scan_matches_reference(s):
    rng = np.random.default_rng(100 + s)
    a = rng.uniform(0.0, 1.0, size=(2, s, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 8, 4)).astype(np.float32)
    want = JS._ssm_scan(jnp.asarray(a), jnp.asarray(b))
    _close(TS._ssm_scan(torch.from_numpy(a.copy()),
                        torch.from_numpy(b.copy())), want, SSM_TOL)


@pytest.mark.parametrize("s", SEQ_LENS)
def test_ssm_forward_and_state_match_reference(s, tree):
    """Output and the decode state; the port's conv state is K-1 rows
    with zeros in front of a shorter prompt, the reference's only the
    rows it has (its known deviation, ROADMAP §3)."""
    jcfg, cfg = _cfgs()
    jp, tp = _ssm_params(tree)
    x = np.random.default_rng(200 + s).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    yj, sj = JS.ssm_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, jp),
                            jcfg, return_state=True)
    yt, st = TS.ssm_forward(torch.from_numpy(x), tp, cfg, return_state=True)
    _close(yt, yj, SSM_TOL, "y")
    _close(st["h"], sj["h"], SSM_TOL, "h")
    k = cfg.ssm_conv
    have = min(s, k - 1)
    assert st["conv"].shape == (2, k - 1, TS.inner_dim(cfg))
    assert np.asarray(sj["conv"]).shape[1] == have
    _close(st["conv"][:, k - 1 - have:], sj["conv"], SSM_TOL, "conv")
    assert not st["conv"][:, :k - 1 - have].any()
    np.testing.assert_allclose(t2n(TS.ssm_forward(torch.from_numpy(x), tp,
                                                  cfg)), t2n(yt), rtol=0,
                               atol=0)


def test_ssm_decode_steps_from_the_prefill_state(tree):
    """Five steps from a 7-token prefill state: outputs and state each
    step, the port's state updated in place in the tensors it was given."""
    jcfg, cfg = _cfgs()
    jp, tp = _ssm_params(tree)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    _, sj = JS.ssm_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, jp),
                           jcfg, return_state=True)
    _, st = TS.ssm_forward(torch.from_numpy(x), tp, cfg, return_state=True)
    conv, h = st["conv"], st["h"]
    for step in range(5):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        yj, sj = JS.ssm_decode(jnp.asarray(x1), sj,
                               jax.tree.map(jnp.asarray, jp), jcfg)
        yt, st = TS.ssm_decode(torch.from_numpy(x1), st, tp, cfg)
        assert st["conv"] is conv and st["h"] is h
        _close(yt, yj, SSM_TOL, f"y step {step}")
        _close(h, sj["h"], SSM_TOL, f"h step {step}")
        _close(conv, sj["conv"], SSM_TOL, f"conv step {step}")
    zero = TS.init_ssm_state(3, cfg, torch.float32, device="cpu")
    want = JS.init_ssm_state(3, jcfg)
    for k in ("conv", "h"):
        assert zero[k].shape == want[k].shape and not zero[k].any()
        assert t2n(zero[k]).dtype == np.asarray(want[k]).dtype


# ------------------------------------------------------------ model parity

@pytest.fixture(scope="module")
def reference_runs(tree):
    """``get(jb, unroll)``: the JAX prefill (2 x 37 tokens) and
    DECODE_STEPS decode steps (jitted, one compile for every step), run
    once for the file: the tokens, the prefill's (logits, caches) and each
    step's."""
    runs = {}
    jcfg, _ = _cfgs()
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]

    def get(jb, unroll=False):
        if (jb, unroll) not in runs:
            prefill = jax.jit(functools.partial(
                JT.prefill_model, cfg=jcfg, policy=JPolicy(**KW),
                max_len=MAX_LEN, backend=jb))
            step = jax.jit(functools.partial(
                JT.decode_step, cfg=jcfg, policy=JPolicy(**KW), backend=jb,
                unroll=unroll))
            out = [prefill(jp, batch={"tokens": jnp.asarray(toks)})]
            for tok in steps:
                out.append(step(jp, token=jnp.asarray(tok),
                                caches=out[-1][1]))
            runs[jb, unroll] = out
        return toks, steps, runs[jb, unroll]
    return get


def _as_port(cj):
    return {"scan": {k: torch.from_numpy(np.asarray(v).copy())
                     for k, v in cj["scan"].items()}}


def _compare_caches(ct, cj):
    for k, want in jax.tree.map(np.asarray, cj)["scan"].items():
        got = ct["scan"][k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k == "length":
            np.testing.assert_array_equal(got, want)
        elif k.startswith("ssm_"):
            np.testing.assert_allclose(got, want, atol=SSM_TOL,
                                       rtol=SSM_TOL, err_msg=k)
        elif k.startswith(("sink_", "win_")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            rate = float(np.mean(got != want))
            assert rate <= FLIP_RATE, (k, rate)
    assert sorted(ct["scan"]) == sorted(cj["scan"])


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(tb, jb, tree, reference_runs):
    """Prefill 2 x 37 tokens, then DECODE_STEPS steps from the reference's
    caches: logits each step; caches (the SSM state included) after the
    prefill and the last step."""
    _, cfg = _cfgs()
    toks, steps, out = reference_runs(jb)
    tp = params_from_numpy(tree, cfg, device="cpu")
    lt, ct = T.prefill_model(tp, cfg, torch.from_numpy(toks),
                             QuantPolicy(**KW), max_len=MAX_LEN, backend=tb)
    _close(lt, out[0][0], LOGIT_TOL, "prefill")
    _compare_caches(ct, out[0][1])
    ct = _as_port(out[0][1])
    for i, tok in enumerate(steps):
        lt, ct = T.decode_step(tp, cfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), backend=tb)
        _close(lt, out[i + 1][0], LOGIT_TOL, f"step {i}")
    _compare_caches(ct, out[-1][1])


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_unrolled_step_matches_reference_and_default(tb, jb, tree,
                                                     reference_runs):
    """``unroll=True`` (the local layers' hoisted slices, pre-append) from
    the reference's prefill: JAX's unrolled step and the port's default
    step, each step (policy window 8 = local window 8, so both orders
    attend the same tokens), and the SSM state after the last."""
    _, cfg = _cfgs()
    _, steps, out = reference_runs(jb, unroll=True)
    tp = params_from_numpy(tree, cfg, device="cpu")
    cu, cd = _as_port(out[0][1]), _as_port(out[0][1])
    for i, tok in enumerate(steps):
        lu, cu = T.decode_step(tp, cfg, torch.from_numpy(tok), cu,
                               QuantPolicy(**KW), backend=tb, unroll=True)
        ld, cd = T.decode_step(tp, cfg, torch.from_numpy(tok), cd,
                               QuantPolicy(**KW), backend=tb)
        _close(lu, out[i + 1][0], LOGIT_TOL, f"unrolled, step {i}")
        _close(lu, t2n(ld), LOGIT_TOL, f"unrolled vs default, step {i}")
    _compare_caches(cu, out[-1][1])


def test_collect_kv_matches_reference(tree):
    """The attention K/V of every layer (the reference runs
    ``full_attention``, the port the prefill's block loop: within 1e-4),
    and the sinks the prefill quantizes are its first rows."""
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 40))
    jk, jv = JT.collect_kv(jax.tree.map(jnp.asarray, tree), jcfg,
                           {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_samples=100)
    tp = params_from_numpy(tree, cfg, device="cpu")
    tk, tv = T.collect_kv(tp, cfg, torch.from_numpy(toks), max_samples=100)
    assert tk.shape == (cfg.n_layers, 100, cfg.n_kv_heads, cfg.head_dim)
    _close(tk, jk, KV_TOL, "k")
    _close(tv, jv, KV_TOL, "v")
    _, caches = T.prefill_model(tp, cfg, torch.from_numpy(toks)[:1, :20],
                                QuantPolicy(**KW), max_len=MAX_LEN,
                                backend="reference")
    k20, _ = T.collect_kv(tp, cfg, torch.from_numpy(toks)[:1, :20])
    assert torch.equal(caches["scan"]["sink_k"][:, 0],
                       k20[:, :KW["n_sink"]])


# ------------------------------------------------------------ engines

def _streams(eng, traffic, request):
    hs = [eng.submit(request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert all(h.finished for h in hs)
    return [list(h.tokens) for h in hs]


def test_engine_streams_equal_reference(tree):
    """Two waves on 2 slots, the first an equal-length pair (one batched
    prefill), prompts past the local window and 6-9 new tokens: the
    port's eager and warmed Engines (cuda backend) against the reference
    Engine (reference backend).  The Engine's caches carry the SSM state
    (``ssm_conv``/``ssm_h``, allocated beside the planes), which slot
    reuse must reset and admission must insert."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
               for n, m in zip((20, 20, 12, 12), (9, 6, 8, 7))]
    kw = dict(batch_slots=2, max_len=52, steps_per_sync=4)
    want = _streams(jsv.Engine(jax.tree.map(jnp.asarray, tree), jcfg,
                               JPolicy(**KW), backend="reference", **kw),
                    traffic, jsv.Request)
    tp = params_from_numpy(tree, cfg, device="cpu")
    eager = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                       device="cpu", **kw)
    assert _streams(eager, traffic, tsv.Request) == want
    assert {"ssm_conv", "ssm_h"} <= set(eager._caches["scan"])
    assert eager._caches["scan"]["ssm_h"].dtype == torch.float32
    warm = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                      device="cpu", **kw)
    warm.warmup()
    assert _streams(warm, traffic, tsv.Request) == want
    assert warm.warmup_report()["post_warmup_misses"] == 0


@pytest.mark.parametrize("what", ["pool", "chunk"])
def test_refusals_equal_reference(what, tree):
    """Pool and chunk refuse the hybrid family at build time, with the
    reference's messages."""
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


# ------------------------------------------------------------ CLI

@pytest.mark.parametrize("arch", ["hymba_1p5b", "hymba-1.5b"])
def test_cli_serves_hymba_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--requests", "3", "--prompt-len", "24",
                 "--new-tokens", "6", "--window", "8", "--sinks", "2",
                 "--group-size", "16"])
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b" in out
