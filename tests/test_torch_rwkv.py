"""The port's attention-free family (``rwkv6_3b``, RWKV6 "Finch": no KV
cache, an O(1) recurrent state a layer) against the JAX reference, on the
same seeded numpy inputs, at the SMOKE shape, in f32.

The reference's params are drawn by ``jax.random`` once for the file and
carried over with ``params_from_numpy``; the JAX prefill and decode runs
are jitted and shared by a module fixture.  Neither backend touches this
family (there is no cache to quantize or attend), so the port's two
backends are held to the JAX package's two all the same.

Tolerances, and why:
* the constant leaves of ``init_params`` (``w0`` -1, ``gn_w`` 1, ``gn_b``
  and the norms 0): EXACT; the token-shift mixes ``mu_*`` are uniform
  draws in [0, 1).
* ``wkv_naive`` against the same JAX function: f32 ``atol = rtol =
  1e-5`` (the same f32 products summed in another order); ``wkv_chunked``
  against JAX's: ``atol = rtol = 1e-4``, since its ``exp(±Σ log w)``
  factors reach e^±80 within a chunk and the masked products of such
  factors carry ~1e-5 relative rounding over 300 steps; a wrong decay,
  bonus or state carry moves y by 1e-2 or more.
  The chunked form against the naive one in the port: the reference
  test's ``atol 2e-4, rtol 1e-3`` (``tests/test_models.py``).
* ``time_mix``, ``time_mix_decode`` (output and state) and
  ``channel_mix``: ``atol = rtol = 1e-5``, the projections' f32 products
  on top of the above.
* logits of the prefill and of each decode step: ``atol = rtol = 2e-4``
  (the bound of ``tests/test_torch_moe.py``: the above through 2 layers
  and the tied unembedding); the state leaves ``wkv``, ``x_prev``,
  ``x_prev_ffn``: ``atol = rtol = 1e-4``.
* greedy token streams of the Engines: equal, token for token.
* refusals and the CLI summary: equal, word for word.
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serving as jsv
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import rwkv6 as JR
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCH = "rwkv6_3b"
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
WKV_TOL = 1e-5
CHUNKED_TOL = 1e-4
MIX_TOL = 1e-5
LOGIT_TOL = 2e-4
STATE_TOL = 1e-4
NAIVE_ATOL, NAIVE_RTOL = 2e-4, 1e-3
SEQ_LENS = [1, 16, 48, 300]        # 1 and 300 are padded to whole chunks
DECODE_STEPS = 6


@pytest.fixture(scope="module")
def tree():
    """The reference's params as numpy, drawn once for the file."""
    return jax.tree.map(np.asarray, JT.init_params(
        jconfigs.get_smoke(ARCH), jax.random.PRNGKey(3)))


def _cfgs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _layer(tree, i=1):
    """Layer ``i``'s params: (numpy for JAX, tensors for the port)."""
    p = {k: v[i] for k, v in tree["layers"].items()
         if not isinstance(v, dict)}
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
        assert got.family == "ssm" and got.attn_free
        assert (got.rwkv_head_dim, got.rwkv_lora_rank, got.remat,
                got.remat_policy) == (want.rwkv_head_dim,
                                      want.rwkv_lora_rank, want.remat,
                                      want.remat_policy)
    assert configs.get("rwkv6-3b") == configs.get(ARCH)
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.d_model // full.rwkv_head_dim,
            full.d_ff, full.vocab_size) == (32, 2560, 40, 8960, 65536)


def test_init_params_leaves_and_constants_equal_reference(tree):
    """The port's init holds the reference's leaves at their shapes, its
    constant leaves bit for bit and its token-shift mixes in [0, 1); the
    conversion takes the reference's params and checks its tree."""
    _, cfg = _cfgs()
    tp = T.init_params(cfg, seed=0, device="cpu")
    params_from_numpy(tree_to_numpy(tp), cfg, device="cpu")   # checks
    flat = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {k: v.shape for k, v in flat.items()} == T.param_shapes(cfg)
    specs = T.param_specs(cfg)
    const = [k for k, (_, init) in specs.items()
             if not isinstance(init, float) and init != T.UNIFORM
             or init == 0]
    assert {"layers/w0", "layers/gn_w", "layers/gn_b", "layers/norm1/w",
            "layers/norm2/w", "final_norm/w"} == set(const)
    got = {"/".join(p.key for p in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(tree_to_numpy(tp))[0]}
    for k in const:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    uni = [k for k, (_, init) in specs.items() if init == T.UNIFORM]
    assert len(uni) == 7
    for k in uni:
        assert got[k].min() >= 0 and got[k].max() < 1 and got[k].std() > 0.1
    assert T.count_params(tp) == JT.count_params(tree)
    with pytest.raises(ValueError, match="lack leaf 'layers/w0'"):
        params_from_numpy({**tree, "layers": {
            k: v for k, v in tree["layers"].items() if k != "w0"}}, cfg,
            device="cpu")


# ------------------------------------------------------------ wkv

def _wkv_inputs(s, with_s0, b=2, h=4, d=16):
    """The reference test's input law: normal r/k/v/u, log-decay
    -exp(N(0,1) - 1) clamped to [-5, -1e-4]; a zero or a random state."""
    rng = np.random.default_rng(300 + s + with_s0)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.normal(size=(b, s, h, d)) - 1), -5.0,
                   -1e-4).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) if with_s0
          else np.zeros((b, h, d, d))).astype(np.float32)
    return r, k, v, logw, u, s0


def _pad(r, k, v, logw):
    """To whole chunks as ``time_mix`` pads: zero r/k/v, log-decay -1e-4."""
    pad = (-r.shape[1]) % TR.CHUNK
    z = lambda a, val=0.0: np.concatenate(
        [a, np.full((a.shape[0], pad) + a.shape[2:], val, a.dtype)], 1)
    return z(r), z(k), z(v), z(logw, -1e-4)


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0=0", "s0"])
@pytest.mark.parametrize("s", SEQ_LENS)
def test_wkv_matches_reference(s, with_s0):
    """Both forms against the same JAX function (the chunked one on the
    inputs padded to whole chunks, as ``time_mix`` pads them: y of the
    real steps and the final state), and the chunked form against the
    naive recurrence in the port."""
    r, k, v, logw, u, s0 = _wkv_inputs(s, with_s0)
    pr, pk, pv, pw = _pad(r, k, v, logw)
    T_ = lambda *a: [torch.from_numpy(x.copy()) for x in a]
    J_ = lambda *a: [jnp.asarray(x) for x in a]
    yc, sc = TR.wkv_chunked(*T_(pr, pk, pv, pw, u, s0))
    yjc, sjc = jax.jit(JR.wkv_chunked)(*J_(pr, pk, pv, pw, u, s0))
    _close(yc[:, :s], np.asarray(yjc)[:, :s], CHUNKED_TOL, "chunked y")
    _close(sc, sjc, CHUNKED_TOL, "chunked state")
    yn, sn = TR.wkv_naive(*T_(r, k, v, logw, u, s0))
    yjn, sjn = jax.jit(JR.wkv_naive)(*J_(r, k, v, logw, u, s0))
    _close(yn, yjn, WKV_TOL, "naive y")
    _close(sn, sjn, WKV_TOL, "naive state")
    np.testing.assert_allclose(t2n(yc[:, :s]), t2n(yn), atol=NAIVE_ATOL,
                               rtol=NAIVE_RTOL)
    if s % TR.CHUNK == 0:
        np.testing.assert_allclose(t2n(sc), t2n(sn), atol=NAIVE_ATOL,
                                   rtol=NAIVE_RTOL)


# ------------------------------------------------------------ mixes

@pytest.mark.parametrize("s", [1, 48, 300])
def test_time_mix_and_channel_mix_match_reference(s, tree):
    """Full-sequence time-mix (output and final state; the tail padded)
    and channel-mix on the normed rows of one layer."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(tree)
    x = np.random.default_rng(400 + s).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    yj, sj = JR.time_mix(jnp.asarray(x), jax.tree.map(jnp.asarray, jp), jcfg)
    yt, st = TR.time_mix(torch.from_numpy(x), tp, cfg)
    _close(yt, yj, MIX_TOL, "time_mix y")
    _close(st, sj, MIX_TOL, "time_mix state")
    _close(TR.channel_mix(torch.from_numpy(x), tp),
           JR.channel_mix(jnp.asarray(x), jax.tree.map(jnp.asarray, jp)),
           MIX_TOL, "channel_mix")


def test_time_mix_decode_steps_in_place(tree):
    """Five steps from a 7-token time-mix state: outputs and state each
    step, the port's ``wkv`` and ``x_prev`` written in place in the
    tensors it was given; channel-mix with a predecessor row; the zero
    state's shapes and dtypes."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(tree)
    jpp = jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    _, sj = JR.time_mix(jnp.asarray(x), jpp, jcfg)
    _, st = TR.time_mix(torch.from_numpy(x), tp, cfg)
    js = {"wkv": sj, "x_prev": jnp.asarray(x[:, -1:])}
    ts = {"wkv": st.clone(), "x_prev": torch.from_numpy(x[:, -1:].copy())}
    wkv, x_prev = ts["wkv"], ts["x_prev"]
    for step in range(5):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        yj, js = JR.time_mix_decode(jnp.asarray(x1), jpp, jcfg, js)
        yt, ts = TR.time_mix_decode(torch.from_numpy(x1), tp, cfg, ts)
        assert ts["wkv"] is wkv and ts["x_prev"] is x_prev
        _close(yt, yj, MIX_TOL, f"y step {step}")
        _close(wkv, js["wkv"], MIX_TOL, f"wkv step {step}")
        _close(x_prev, js["x_prev"], 0, f"x_prev step {step}")
        prev = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        _close(TR.channel_mix(torch.from_numpy(x1), tp,
                              x_prev=torch.from_numpy(prev)),
               JR.channel_mix(jnp.asarray(x1), jpp,
                              x_prev=jnp.asarray(prev)), MIX_TOL,
               f"channel_mix step {step}")
    zero = TR.init_rwkv_state(3, cfg, torch.float32, device="cpu")
    want = JR.init_rwkv_state(3, jcfg)
    assert sorted(zero) == sorted(want)
    for k in want:
        assert zero[k].shape == want[k].shape and not zero[k].any()
        assert t2n(zero[k]).dtype == np.asarray(want[k]).dtype
    assert T.layer_cache_shapes(cfg, 3, 64, QuantPolicy(**KW)) == \
        T.layer_cache_shapes(cfg, 3, 1 << 20, QuantPolicy(**KW)) == \
        TR.state_shapes(3, cfg, torch.bfloat16)


# ------------------------------------------------------------ model parity

@pytest.fixture(scope="module")
def reference_runs(tree):
    """``get(jb)``: the JAX prefill (2 x 37 tokens) and DECODE_STEPS
    decode steps (jitted, one compile for every step), run once for the
    file: the tokens, the prefill's (logits, caches) and each step's."""
    runs = {}
    jcfg, _ = _cfgs()
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]

    def get(jb):
        if jb not in runs:
            prefill = jax.jit(functools.partial(
                JT.prefill_model, cfg=jcfg, policy=JPolicy(**KW),
                max_len=64, backend=jb))
            step = jax.jit(functools.partial(
                JT.decode_step, cfg=jcfg, policy=JPolicy(**KW), backend=jb))
            out = [prefill(jp, batch={"tokens": jnp.asarray(toks)})]
            for tok in steps:
                out.append(step(jp, token=jnp.asarray(tok),
                                caches=out[-1][1]))
            runs[jb] = out
        return toks, steps, runs[jb]
    return get


def _compare_state(ct, cj, what):
    want = jax.tree.map(np.asarray, cj)["scan"]
    assert sorted(ct["scan"]) == sorted(want) == ["wkv", "x_prev",
                                                  "x_prev_ffn"]
    for k, w in want.items():
        got = ct["scan"][k]
        assert got.shape == w.shape, (k, got.shape, w.shape)
        _close(got, w, STATE_TOL, f"{what} {k}")


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(tb, jb, tree, reference_runs):
    """Prefill 2 x 37 tokens (not a whole number of chunks), then
    DECODE_STEPS steps from the port's own state: logits each step and
    the state after the prefill and after every step; the step writes the
    state in place."""
    _, cfg = _cfgs()
    toks, steps, out = reference_runs(jb)
    tp = params_from_numpy(tree, cfg, device="cpu")
    lt, ct = T.prefill_model(tp, cfg, torch.from_numpy(toks),
                             QuantPolicy(**KW), max_len=64, backend=tb)
    _close(lt, out[0][0], LOGIT_TOL, "prefill")
    _compare_state(ct, out[0][1], "prefill")
    wkv = ct["scan"]["wkv"]
    for i, tok in enumerate(steps):
        lt, ct = T.decode_step(tp, cfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), backend=tb)
        assert ct["scan"]["wkv"] is wkv
        _close(lt, out[i + 1][0], LOGIT_TOL, f"step {i}")
        _compare_state(ct, out[i + 1][1], f"step {i}")


def test_collect_kv_raises_as_reference(tree):
    jcfg, cfg = _cfgs()
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError) as want:
        JT.collect_kv(jax.tree.map(jnp.asarray, tree), jcfg,
                      {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError) as got:
        T.collect_kv(params_from_numpy(tree, cfg, device="cpu"), cfg,
                     torch.from_numpy(toks))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ engines

def _streams(eng, traffic, request):
    hs = [eng.submit(request(prompt=p, max_new=m, seed=i))
          for i, (p, m) in enumerate(traffic)]
    eng.run(hs)
    assert all(h.finished for h in hs)
    return [list(h.tokens) for h in hs]


def test_engine_streams_equal_reference(tree):
    """Three waves on 2 slots over ragged prompts, the first an
    equal-length pair (one batched prefill): the port's eager and warmed
    Engines against the reference Engine, token for token; the Engine's
    caches are the state stack (slot reuse inserts the new state whole),
    and ``stats()`` and ``backend_info``'s accounting equal the
    reference's."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
               for n, m in zip((20, 20, 12, 31, 5), (9, 6, 8, 5, 7))]
    kw = dict(batch_slots=2, max_len=52, steps_per_sync=4)
    jeng = jsv.Engine(jax.tree.map(jnp.asarray, tree), jcfg, JPolicy(**KW),
                      backend="reference", **kw)
    want = _streams(jeng, traffic, jsv.Request)
    tp = params_from_numpy(tree, cfg, device="cpu")
    eager = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                       device="cpu", **kw)
    assert _streams(eager, traffic, tsv.Request) == want
    assert sorted(eager._caches["scan"]) == ["wkv", "x_prev", "x_prev_ffn"]
    assert eager._caches["scan"]["wkv"].dtype == torch.float32
    js, ts = jeng.stats(), eager.stats()
    ts["counters"].pop("cow_copies", None)
    js["counters"].pop("cow_copies", None)
    assert ts == js
    for k in ("schedule_uniform", "n_policies", "avg_bits", "layer_avg_bits",
              "layer_cache_bytes", "cache_bytes_per_slot", "pooled"):
        assert eager.backend_info[k] == jeng.backend_info[k], k
    warm = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                      device="cpu", **kw)
    warm.warmup()
    assert _streams(warm, traffic, tsv.Request) == want
    assert warm.warmup_report()["post_warmup_misses"] == 0


@pytest.mark.parametrize("what", ["pool", "chunk"])
def test_refusals_equal_reference(what, tree):
    """Pool and chunk refuse the family at build time, with the
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


# ------------------------------------------------------------ CLI

SUMMARY = [re.compile(r"^  (?:layers|\d+(?:-\d+)? |schedule ).*$", re.M),
           re.compile(r"^KV bytes/token-head: .*$", re.M),
           re.compile(r"^degradation summary.*?invariant audit: \w+",
                      re.M | re.S)]


@pytest.mark.parametrize("arch", ["rwkv6_3b", "rwkv6-3b"])
def test_cli_summary_equals_the_reference_cli(arch, capsys):
    """One run of each CLI: the schedule table, the KV-bytes line (the
    SKVQ accounting both print for a model with no KV cache, ROADMAP §3)
    and the degradation summary print the same; the random params differ
    between the packages, so the streams do not."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--arch", arch, "--smoke", "--batch", "2", "--requests", "3",
            "--prompt-len", "24", "--new-tokens", "6", "--window", "8",
            "--sinks", "2", "--group-size", "16"]
    jserve.main(args)
    want = capsys.readouterr().out
    tserve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "arch=rwkv6-3b" in got
    for pat in SUMMARY:
        w, g = pat.findall(want), pat.findall(got)
        assert w and g == w, (g, w)
