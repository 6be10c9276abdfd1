"""The port's MoE family (``deepseek_moe_16b``, ``granite_moe_1b_a400m``)
against the JAX reference, on the same seeded numpy inputs, at the SMOKE
shapes, in f32.

The reference's params are drawn by ``jax.random`` and carried over.
Backends are paired by dequant precision, as in
``tests/test_torch_model.py``: port ``"reference"`` with JAX
``"reference"``, port ``"cuda"`` (plain kernel versions on the CPU) with
JAX ``"pallas"`` (interpret mode).  The reference's caches come as
``{"dense": first_dense layers, "scan": the rest}``; the port keeps one
``"scan"`` group over every layer, so the tests concatenate the
reference's two along the layer axis (:func:`_flat`) and compare layer by
layer.

Ties: ``torch.topk`` and ``jax.lax.top_k`` may order equal router
probabilities differently.  Every input here is drawn from a continuous
distribution, so a tie has probability 0; the routing tests assert that
no row's top ``k + 1`` probabilities lie within 1e-6 of each other.

Tolerances, and why:
* ``route``: weights and aux loss f32 ``atol = 1e-6`` (the same softmax
  summed in another order), expert ids EXACT.
* ``moe_ffn_grouped`` / ``moe_ffn_scatter``: f32 ``atol = 1e-5``: the
  dispatch moves values exactly (one-hot products), the expert products
  and the combine sum the same terms in another order; a token routed or
  dropped differently moves the output by 1e-2 or more.
* logits, ``atol = rtol = 2e-4``, cache codes at most 0.5% of packed
  bytes differing, fp sink/window values ``1e-5``, lengths exact: the
  bounds of ``tests/test_torch_families.py``, for the same reasons.
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
from repro.models import moe as JM
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCHS = ["deepseek_moe_16b", "granite_moe_1b_a400m"]
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PAIRS = [("reference", "reference"), ("cuda", "pallas")]
LOGIT_TOL = 2e-4
FLIP_RATE = 5e-3
ROUTE_TOL = 1e-6
FFN_TOL = 1e-5
KV_TOL = 1e-4
TIE_GAP = 1e-6
MAX_LEN = 64                       # packed region of 52 tokens > window 8
DECODE_STEPS = 4


@pytest.fixture(scope="module")
def trees():
    """Each arch's reference params as numpy, drawn once for the file."""
    return {a: jax.tree.map(np.asarray, JT.init_params(
        jconfigs.get_smoke(a), jax.random.PRNGKey(3))) for a in ARCHS}


def _cfgs(arch):
    return jconfigs.get_smoke(arch), configs.get_smoke(arch)


def _flat(cj):
    """The reference's ``{"dense", "scan"}`` caches as the port's one
    group: every leaf concatenated along the layer axis (numpy)."""
    cj = jax.tree.map(np.asarray, cj)
    if "dense" not in cj:
        return cj["scan"]
    return {k: np.concatenate([cj["dense"][k], v])
            for k, v in cj["scan"].items()}


def _as_port(cj):
    return {"scan": {k: torch.from_numpy(v.copy())
                     for k, v in _flat(cj).items()}}


def _close(got, want, what=""):
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg=what)


def _compare_caches(ct, cj):
    """Layer by layer: the port's ``"scan"`` group against the
    reference's groups in layer order."""
    for k, want in _flat(cj).items():
        got = ct["scan"][k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        for layer in range(want.shape[0]):
            g, w = got[layer], want[layer]
            if k == "length":
                np.testing.assert_array_equal(g, w)
            elif k.startswith(("sink_", "win_")):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{k} layer {layer}")
            else:
                rate = float(np.mean(g != w))
                assert rate <= FLIP_RATE, (k, layer, rate)


def _moe_params(tree):
    """Layer 0 of the ``layers`` stack's MoE params, numpy."""
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def _skewed_tokens(p, d, n, seed):
    """n router inputs (numpy f32) leaning toward expert 0, so that it
    overflows its capacity: normal rows plus 4 x expert 0's unit router
    column."""
    rng = np.random.default_rng(seed)
    r0 = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    return (rng.normal(size=(n, d)) + 4.0 * r0).astype(np.float32)


def _assert_no_ties(x, router, k):
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router),
                                      axis=-1))
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    assert float(np.min(top[:, :-1] - top[:, 1:])) > TIE_GAP


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for get in ("get", "get_smoke"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert got == ArchConfig(**{f: getattr(want, f) for f in
                                    ArchConfig.__dataclass_fields__}), get
        assert got.is_moe and got.is_moe == want.is_moe
    alias = {"deepseek_moe_16b": "deepseek-moe-16b",
             "granite_moe_1b_a400m": "granite-moe-1b-a400m"}[arch]
    assert configs.get(alias) == configs.get(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaves_equal_reference(arch, trees):
    """The port's init holds the reference's leaves (``dense_layers`` for
    the first dense layers, ``layers/moe/...`` with shared experts as the
    config asks) at their shapes; the conversion takes the reference's
    params and checks its own tree against the config."""
    jcfg, cfg = _cfgs(arch)
    tp = T.init_params(cfg, seed=0, device="cpu")
    params_from_numpy(tree_to_numpy(tp), cfg, device="cpu")   # checks
    flat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(trees[arch])[0]}
    assert flat == T.param_shapes(cfg)
    assert ("dense_layers/mlp/wo" in flat) == (cfg.first_dense > 0)
    assert ("layers/moe/shared_up" in flat) == (cfg.n_shared_experts > 0)
    conv = params_from_numpy(trees[arch], cfg, device="cpu")
    np.testing.assert_array_equal(conv["layers"]["moe"]["experts_down"],
                                  trees[arch]["layers"]["moe"]
                                  ["experts_down"])
    with pytest.raises(ValueError, match="lack leaf 'layers/moe/router'"):
        params_from_numpy({**trees[arch], "layers": {
            **trees[arch]["layers"], "moe": {
                k: v for k, v in trees[arch]["layers"]["moe"].items()
                if k != "router"}}}, cfg, device="cpu")


# ------------------------------------------------------------ routing

def test_capacity_matches_reference():
    for arch in ARCHS:
        for get in (configs.get, configs.get_smoke):
            cfg = get(arch)
            jcfg = getattr(jconfigs, get.__name__)(arch)
            for cf in (0.5, 1.0, 1.25, 2.0):
                for n in list(range(1, 70)) + [100, 511, 4096, 5000, 12288]:
                    assert TM._capacity(n, cfg.scaled(capacity_factor=cf)) \
                        == JM._capacity(n, jcfg.scaled(capacity_factor=cf))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, trees):
    jcfg, cfg = _cfgs(arch)
    p = _moe_params(trees[arch])
    x = np.random.default_rng(5).normal(size=(96, cfg.d_model)).astype(
        np.float32)
    _assert_no_ties(x, p["router"], cfg.top_k)
    wj, ij, aj = JM.route(jnp.asarray(x), jnp.asarray(p["router"]), jcfg)
    router = torch.from_numpy(p["router"].copy())
    wt, it, at = TM.route(torch.from_numpy(x), router, cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ROUTE_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=ROUTE_TOL, rtol=0)
    wn, inn, none = TM.route(torch.from_numpy(x), router, cfg,
                             with_aux=False)
    assert none is None and torch.equal(wn, wt) and torch.equal(inn, it)


@pytest.mark.parametrize("n", [64, 5000])
@pytest.mark.parametrize("dispatch", ["grouped", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dispatch, n, trees):
    """Tokens leaning toward expert 0 at the default capacity factor.  At
    n = 64 (one group) expert 0 overflows and drops tokens in either
    dispatch: the output moves when the capacity is lifted.  At n = 5000
    the grouped dispatch halves its group from 4096 down to 8 (5000 = 625
    x 8, capacity 8 a group) and the scatter dispatch drops against one
    capacity over all 5000."""
    jcfg, cfg = _cfgs(arch)
    cfg, jcfg = (c.scaled(moe_dispatch=dispatch) for c in (cfg, jcfg))
    p = _moe_params(trees[arch])
    x = _skewed_tokens(p, cfg.d_model, n, seed=n)
    _assert_no_ties(x, p["router"], cfg.top_k)
    x3 = x.reshape(2, n // 2, cfg.d_model)
    yj, aj = JM.moe_ffn(jnp.asarray(x3), jax.tree.map(jnp.asarray, p), jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    yt, at = TM.moe_ffn(torch.from_numpy(x3), tp, cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FFN_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=ROUTE_TOL, rtol=0)
    roomy, _ = TM.moe_ffn(torch.from_numpy(x3), tp,
                          cfg.scaled(capacity_factor=float(cfg.n_experts)))
    dropped = float((roomy - yt).abs().max()) > 1e-3
    assert dropped == (n == 64 or dispatch == "scatter")
    if n == 5000:
        assert 5000 % TM.GROUP_TOKENS and TM._capacity(8, cfg) == 8


# ------------------------------------------------------------ model parity

@pytest.fixture(scope="module")
def reference_runs(trees):
    """``get(arch, jb)``: the JAX prefill (2 x 37 tokens) and DECODE_STEPS
    decode steps of one arch and backend (jitted, as the reference serves
    them: one compile for every step), run once for the file: the
    tokens, the prefill's (logits, caches) and each step's."""
    runs = {}

    def get(arch, jb):
        if (arch, jb) not in runs:
            jcfg, _ = _cfgs(arch)
            rng = np.random.default_rng(11)
            jp = jax.tree.map(jnp.asarray, trees[arch])
            toks = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
            steps = [rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
                     for _ in range(DECODE_STEPS)]
            prefill = jax.jit(functools.partial(
                JT.prefill_model, cfg=jcfg, policy=JPolicy(**KW),
                max_len=MAX_LEN, backend=jb))
            step = jax.jit(functools.partial(
                JT.decode_step, cfg=jcfg, policy=JPolicy(**KW), backend=jb))
            out = [prefill(jp, batch={"tokens": jnp.asarray(toks)})]
            for tok in steps:
                out.append(step(jp, token=jnp.asarray(tok),
                                caches=out[-1][1]))
            runs[arch, jb] = (toks, steps, out)
        return runs[arch, jb]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(arch, tb, jb, trees,
                                            reference_runs):
    """Prefill 2 x 37 tokens (74 tokens route against one capacity), then
    DECODE_STEPS steps from the reference's caches: logits each step,
    caches layer by layer after the prefill and the last step."""
    _, cfg = _cfgs(arch)
    toks, steps, out = reference_runs(arch, jb)
    tp = params_from_numpy(trees[arch], cfg, device="cpu")
    lt, ct = T.prefill_model(tp, cfg, torch.from_numpy(toks),
                             QuantPolicy(**KW), max_len=MAX_LEN, backend=tb)
    _close(lt, out[0][0], "prefill")
    _compare_caches(ct, out[0][1])
    ct = _as_port(out[0][1])
    for i, tok in enumerate(steps):
        lt, ct = T.decode_step(tp, cfg, torch.from_numpy(tok), ct,
                               QuantPolicy(**KW), backend=tb)
        _close(lt, out[i + 1][0], f"step {i}")
    _compare_caches(ct, out[-1][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_collect_kv_matches_reference(arch, trees):
    """The port returns every layer's K/V; the reference runs its
    ``dense_layers`` but returns only the ``layers`` scan's (its known
    deviation, ROADMAP §3), which the port's layers ``first_dense..``
    match."""
    jcfg, cfg = _cfgs(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 40))
    jk, jv = JT.collect_kv(jax.tree.map(jnp.asarray, trees[arch]), jcfg,
                           {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_samples=100)
    tp = params_from_numpy(trees[arch], cfg, device="cpu")
    tk, tv = T.collect_kv(tp, cfg, torch.from_numpy(toks), max_samples=100)
    nf = cfg.first_dense
    assert tk.shape == (cfg.n_layers, 100, cfg.n_kv_heads, cfg.head_dim)
    assert jk.shape[0] == cfg.n_layers - nf
    np.testing.assert_allclose(tk[nf:].numpy(), np.asarray(jk), atol=KV_TOL,
                               rtol=KV_TOL)
    np.testing.assert_allclose(tv[nf:].numpy(), np.asarray(jv), atol=KV_TOL,
                               rtol=KV_TOL)
    # the dense layers' K/V are the ones the prefill quantizes
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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_reference(arch, trees):
    """Two waves on 2 slots whose first wave is an equal-length pair (one
    batched prefill: 2 x 20 tokens route against one capacity), then two
    prompts of 12 tokens, 6-9 new (two prompt lengths keep the reference
    Engine's compiles few): the port's eager and warmed Engines (cuda
    backend) against the reference Engine (reference backend)."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
               for n, m in zip((20, 20, 12, 12), (9, 6, 8, 7))]
    kw = dict(batch_slots=2, max_len=52, steps_per_sync=4)
    want = _streams(jsv.Engine(jax.tree.map(jnp.asarray, trees[arch]), jcfg,
                               JPolicy(**KW), backend="reference", **kw),
                    traffic, jsv.Request)
    tp = params_from_numpy(trees[arch], cfg, device="cpu")
    eager = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                       device="cpu", **kw)
    assert _streams(eager, traffic, tsv.Request) == want
    warm = tsv.Engine(tp, cfg, QuantPolicy(**KW), backend="cuda",
                      device="cpu", **kw)
    warm.warmup()
    assert _streams(warm, traffic, tsv.Request) == want
    assert warm.warmup_report()["post_warmup_misses"] == 0


@pytest.mark.parametrize("what", ["pool", "chunk"])
def test_moe_refusals_equal_reference(what, trees):
    """Pool and chunk refuse the moe family at build time, with the
    reference's messages."""
    arch = "deepseek_moe_16b"
    jcfg, cfg = _cfgs(arch)
    kw = (dict(pool_blocks=40, pool_block_tokens=8) if what == "pool"
          else dict(prefill_chunk=8))
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jsv.Engine(jax.tree.map(jnp.asarray, trees[arch]), jcfg,
                   JPolicy(**KW), batch_slots=2, max_len=52, **kw)
    tp = params_from_numpy(trees[arch], cfg, device="cpu")
    with pytest.raises(want.type) as got:
        tsv.Engine(tp, cfg, QuantPolicy(**KW), batch_slots=2, max_len=52,
                   device="cpu", **kw)
    assert str(got.value) == str(want.value)
    if what == "chunk":
        with pytest.raises(NotImplementedError, match="moe expert capacity"):
            T.prefill_chunk_init(cfg, QuantPolicy(**KW), 52, 52,
                                 device="cpu")


# ------------------------------------------------------------ CLI

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "granite-moe-1b-a400m"])
def test_cli_serves_the_moe_archs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--requests", "3", "--prompt-len", "24",
                 "--new-tokens", "6", "--window", "8", "--sinks", "2",
                 "--group-size", "16"])
    out = capsys.readouterr().out
    assert f"arch={configs.get(arch).name}" in out
