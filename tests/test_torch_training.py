"""The port's single-device training path (``transformer.forward_train``
and ``count_params``, ``training/*``, the loader of ``data/pipeline.py``,
``distributed/compression.py`` and the trainer CLI) against the JAX
reference, on the same seeded numpy inputs, at the SMOKE shapes, in f32.

The reference's params and train states are drawn by ``jax.random`` and
carried over with ``convert.params_from_numpy`` /
``train_state_from_numpy``; its runs are jitted and shared by module
fixtures.

Tolerances, and why:
* ``forward_train``: logits ``atol = rtol = 1e-4`` and the MoE aux loss
  ``rtol = 1e-5``; the loss ``rtol = 1e-6`` and each gradient leaf within
  ``1e-4`` of that leaf's largest magnitude (max |dg| / max |g|): the same
  f32 products summed in another order, through two layers and the
  backward pass (measured: at most 2.3e-5, RWKV6's chunked WKV).  Remat
  on against off in the port: the same bounds (they recompute the same
  ops, so they agree far inside them).
* ``loss_fn``, ``global_norm``: ``rtol = 1e-6``; ``warmup_cosine``:
  ``rtol = 1e-6`` (the cosine of another library, one f32 ulp).
* ``adamw_update`` on the same grads, moments and params: within 2 f32
  ulps (the same f32 operations in the same order; ``sqrt`` and the
  divisions are correctly rounded in both, ``pow`` may differ in the last
  bit of the bias correction).
* train steps from the same converted state on the same batches.  AdamW
  normalizes each update to about ±lr, so where |g| is near eps or zero a
  last-bit difference in g moves a weight by up to 2·lr (a sign flip);
  such weights are counted, as the cache tests count code flips.  After
  one step: loss, nll and grad norm ``rtol = 1e-5``; weights whose update
  differs by more than ``1e-5`` at most 0.1% of all (measured: 3 of
  90,432, the largest lr/4), none by more than 2·lr; the moments within
  ``1e-4`` of each leaf's largest magnitude.  After five steps those
  weights feed the next gradients, so the runs drift: metrics
  ``rtol = 5e-4`` (measured 9e-5), weights past ``1e-4`` at most 0.1% of
  all (the 99.9th percentile measured 7.4e-5), none past 2·lr, moments
  within ``1e-2`` of each leaf's largest magnitude (measured 1.9e-3).
* ``ef_int8_compress``: EXACT (per-tensor scale, round-half-even).
* ``DataLoader`` batches and passkey samples: byte-equal.
* decode against the port's own ``forward_train``: the reference test's
  bounds (``tests/test_serve.py``: prefill ``atol 2e-3, rtol 1e-3``,
  decode within 5% of the logits' scale + 0.02).
* the trainer CLI: its lines equal the reference CLI's with the loss,
  grad norm and ms masked (the random params differ between packages);
  lr printed equal.
"""
import dataclasses
import functools
import os
import re
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import DataLoader as JLoader
from repro.data import SyntheticCorpus as JCorpus
from repro.data import make_passkey_sample as j_passkey
from repro.distributed.compression import ef_int8_compress as j_ef
from repro.models import transformer as JT
from repro.training import adamw_init as j_adamw_init
from repro.training import adamw_update as j_adamw_update
from repro.training import global_norm as j_global_norm
from repro.training import init_train_state as j_init_state
from repro.training import loss_fn as j_loss_fn
from repro.training import make_train_step as j_make_step
from repro.training import warmup_cosine as j_warmup_cosine

from repro_torch import configs
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import DataLoader, SyntheticCorpus, make_passkey_sample
from repro_torch.distributed.compression import ef_int8_compress
from repro_torch.models import transformer as T
from repro_torch.training import (adamw_init, adamw_update, global_norm,
                                  init_train_state, loss_fn, make_train_step,
                                  warmup_cosine)
from repro_torch.tree import leaves, unflatten
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

FAMILIES = ["llama3p2_1b", "gemma2_27b", "qwen2_vl_7b",
            "granite_moe_1b_a400m", "hymba_1p5b", "rwkv6_3b",
            "seamless_m4t_large_v2"]
REMAT = [None, "nothing", "dots"]
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
STEP_RTOL = 1e-5                  # the first step (see the docstring)
DRIFT_RTOL = 5e-4                 # later steps
PARAM_ATOL = {1: 1e-5, 5: 1e-4}   # after n steps, past it: "flipped"
MOMENT_TOL = {1: 1e-4, 5: 1e-2}
FLIP_SHARE = 1e-3
CPU = "cpu"


def _batch(cfg, rng, b=2, s=24):
    """(JAX batch, port batch) with the config's inputs and labels."""
    out = {}
    if cfg.input_embeds:
        out["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.normal(
            size=(b, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _port_loss_grads(params, cfg, batch):
    flat = [x.detach().requires_grad_() for x in leaves(params)]
    logits, aux = T.forward_train(unflatten(params, flat), cfg, batch)
    loss, _ = loss_fn(logits, batch["labels"], aux)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return logits.detach(), aux.detach(), loss.detach(), grads


@pytest.fixture(scope="module")
def reference_forward():
    """``get(arch)``: the reference's params (numpy), batch, logits, aux,
    loss and gradients (in ``jax.tree.leaves`` order), once per arch."""
    runs = {}

    def get(arch):
        if arch not in runs:
            jcfg = jconfigs.get_smoke(arch)
            if jcfg.is_moe:
                jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
            tree = jax.tree.map(np.asarray, JT.init_params(
                jcfg, jax.random.PRNGKey(1)))
            jb, tb = _batch(jcfg, np.random.default_rng(0))

            def f(p):
                logits, aux = JT.forward_train(p, jcfg, jb)
                return j_loss_fn(logits, jb["labels"], aux)[0], (logits, aux)
            (loss, (logits, aux)), grads = jax.jit(
                jax.value_and_grad(f, has_aux=True))(
                    jax.tree.map(jnp.asarray, tree))
            runs[arch] = (tree, tb, np.asarray(logits), float(aux),
                          float(loss), [np.asarray(g) for g in
                                        jax.tree.leaves(grads)])
        return runs[arch]
    return get


def _grad_rel(got, want):
    return max(float(np.abs(t2n(g) - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


@pytest.mark.parametrize("remat", REMAT, ids=lambda r: f"remat={r}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_and_grads_match_reference(arch, remat,
                                                 reference_forward):
    """Logits, aux loss, the loss and every gradient leaf of the port's
    forward (remat off, full per-block recompute, and the selective
    ``dots`` policy) against the reference's ``value_and_grad``; a remat
    run recomputes each block once in the backward pass."""
    tree, tb, logits, aux, loss, grads = reference_forward(arch)
    cfg = configs.get_smoke(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
    params = params_from_numpy(tree, cfg, device=CPU)
    calls = []
    block = T._block_rwkv if cfg.family == "ssm" else T._block_full
    name = block.__name__

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, name, counted)
        lt, at, lost, gt = _port_loss_grads(params, cfg, tb)
    assert len(calls) == cfg.n_layers * (2 if remat else 1)
    np.testing.assert_allclose(t2n(lt), logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(at) == pytest.approx(aux, rel=1e-5, abs=1e-7)
    assert float(lost) == pytest.approx(loss, rel=LOSS_RTOL)
    assert _grad_rel(gt, grads) <= GRAD_TOL


@pytest.mark.parametrize("arch", FAMILIES + ["deepseek_moe_16b"])
def test_count_params_equals_reference(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    tree = JT.init_params(jcfg, jax.random.PRNGKey(0))
    assert T.count_params(T.init_params(cfg, seed=0, device=CPU)) == \
        JT.count_params(tree)
    full = configs.get(arch)
    assert T.count_params({k: torch.empty(s, device="meta") for k, s in
                           T.param_shapes(full).items()}) == \
        sum(int(np.prod(s)) for s in T.param_shapes(full).values())


# ------------------------------------------------------------ loss / lr

def test_loss_fn_and_global_norm_match_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for aux in (0.0, 0.37):
        jl, jn = j_loss_fn(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.float32(aux))
        tl, tn = loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.tensor(aux))
        assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
        assert float(tn) == pytest.approx(float(jn), rel=LOSS_RTOL)
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    assert float(global_norm({"a": torch.from_numpy(tree["a"]), "b": {
        "c": torch.from_numpy(tree["b"]["c"])}})) == pytest.approx(
        float(j_global_norm(tree)), rel=LOSS_RTOL)


@pytest.mark.parametrize("kw", [dict(peak_lr=1.0, warmup=10, total=100),
                                dict(peak_lr=5e-3, warmup=10, total=120),
                                dict(peak_lr=3e-3, warmup=1, total=3)])
def test_warmup_cosine_matches_reference(kw):
    steps = range(0, kw["total"] + 5)
    want = [float(j_warmup_cosine(jnp.int32(s), **kw)) for s in steps]
    got = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(warmup_cosine(7, **kw)) == pytest.approx(want[7], rel=1e-6)


# ------------------------------------------------------------ adamw

def test_adamw_update_matches_reference_to_f32_rounding():
    """Three updates of the same grads, moments and params (one leaf past
    the clip, one under it, a zero gradient), lr a tensor: params, m, v
    within 2 f32 ulps; the step and the grad norm."""
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=(33, 17)).astype(np.float32),
         "n": {"b": rng.normal(size=(17,)).astype(np.float32)}}
    jp, jo = jax.tree.map(jnp.asarray, p), j_adamw_init(p)
    tp = {"w": torch.from_numpy(p["w"]), "n": {"b": torch.from_numpy(
        p["n"]["b"])}}
    to = adamw_init(tp)
    for i, scale in enumerate((0.01, 3.0, 0.0)):
        g = {"w": (rng.normal(size=(33, 17)) * scale).astype(np.float32),
             "n": {"b": (rng.normal(size=(17,)) * scale).astype(np.float32)}}
        jp, jo, jm = j_adamw_update(jax.tree.map(jnp.asarray, g), jo, jp,
                                    jnp.float32(1e-2))
        tp, to, tm = adamw_update({"w": torch.from_numpy(g["w"]), "n": {
            "b": torch.from_numpy(g["n"]["b"])}}, to, tp,
            torch.tensor(1e-2))
        for want, got in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
            for w, t in zip(jax.tree.leaves(want), leaves(got)):
                np.testing.assert_array_max_ulp(t2n(t), np.asarray(w), 2)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)


def test_adamw_moves_toward_grad_and_clips():
    """The reference's two AdamW tests, through the port."""
    params = {"w": torch.ones(4)}
    new_p, new_opt, m = adamw_update(
        {"w": torch.tensor([1.0, -1.0, 0.0, 2.0])}, adamw_init(params),
        params, lr=0.1, weight_decay=0.0)
    assert float(new_p["w"][0]) < 1.0 and float(new_p["w"][1]) > 1.0
    assert int(new_opt["step"]) == 1
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(6.0), rel=1e-5)
    assert torch.equal(params["w"], torch.ones(4))        # inputs untouched
    params = {"w": torch.zeros(2)}
    _, _, m = adamw_update({"w": torch.tensor([300.0, 400.0])},
                           adamw_init(params), params, lr=0.1, clip_norm=1.0)
    assert float(m["grad_norm"]) == pytest.approx(500.0, rel=1e-5)


# ------------------------------------------------------------ compression

def test_ef_int8_compress_equals_reference():
    """Exact against the reference over 20 steps of error feedback, and
    the reference's two properties: the error within half a scale, and
    the sum of compressed gradients telescoping to the true sum."""
    rng = np.random.default_rng(5)
    jef = {"w": jnp.zeros((64, 64), jnp.float32)}
    tef = {"w": torch.zeros((64, 64))}
    total_true = np.zeros((64, 64), np.float32)
    total_q = np.zeros((64, 64), np.float32)
    for i in range(20):
        g = rng.normal(size=(64, 64)).astype(np.float32)
        jq, jef = j_ef({"w": jnp.asarray(g)}, jef)
        tq, tef = ef_int8_compress({"w": torch.from_numpy(g)}, tef)
        np.testing.assert_array_equal(t2n(tq["w"]), np.asarray(jq["w"]))
        np.testing.assert_array_equal(t2n(tef["w"]), np.asarray(jef["w"]))
        if i == 0:
            scale = np.abs(g).max() / 127
            assert np.abs(t2n(tq["w"]) - g).max() <= scale * 0.51
        total_true += g
        total_q += t2n(tq["w"])
    assert np.abs(total_true - total_q - t2n(tef["w"])).max() < 1e-3


# ------------------------------------------------------------ data

def test_loader_batches_and_passkey_samples_are_byte_equal():
    jl = JLoader(JCorpus(256, seed=1), batch=4, seq=32, seed=3)
    tl = DataLoader(SyntheticCorpus(256, seed=1), batch=4, seq=32, seed=3,
                    device=CPU)
    for step, (tb, jb) in zip((0, 7, 0), ((tl.batch_at(0), jl.batch_at(0)),
                                          (tl.batch_at(7), jl.batch_at(7)),
                                          (next(iter(tl)), next(iter(jl))))):
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        np.testing.assert_array_equal(tb["labels"][:, :-1].numpy(),
                                      tb["tokens"][:, 1:].numpy())
    for seed in range(3):
        jt, jk = j_passkey(JCorpus(300, seed=2), 200, 40,
                           np.random.default_rng(seed))
        tt, tk = make_passkey_sample(SyntheticCorpus(300, seed=2), 200, 40,
                                     np.random.default_rng(seed))
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tk, jk)
        assert (tt[40:46] == tk).all() and (tt[-6:] == tk).all()


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def reference_steps():
    """The reference's train state for llama3.2-1b smoke and the states
    and metrics after each of 5 jitted steps on ``DataLoader`` batches
    (8 x 64) at a constant lr of 5e-3."""
    jcfg = jconfigs.get_smoke("llama3p2_1b")
    st = j_init_state(jcfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, st)
    step = jax.jit(j_make_step(jcfg, lr_fn=lambda s: jnp.float32(5e-3)))
    dl = JLoader(JCorpus(jcfg.vocab_size, seed=1), batch=8, seq=64)
    out = []
    for i in range(5):
        st, m = step(st, dl.batch_at(i))
        out.append((jax.tree.map(np.asarray, st),
                    {k: float(v) for k, v in m.items()}))
    return init, out


@pytest.mark.parametrize("n_steps", [1, 5])
def test_train_steps_match_reference(n_steps, reference_steps):
    """One and five steps from the converted reference state on the same
    batches: metrics each step; params and moments after the last, with
    AdamW sign flips counted and bounded."""
    init, ref = reference_steps
    cfg = configs.get_smoke("llama3p2_1b")
    st = train_state_from_numpy(init, cfg, device=CPU)
    step = make_train_step(cfg, lr_fn=lambda s: 5e-3)
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), batch=8, seq=64,
                    device=CPU)
    lr = 5e-3
    for i in range(n_steps):
        st, m = step(st, dl.batch_at(i))
        for k in ("loss", "nll", "grad_norm"):
            assert float(m[k]) == pytest.approx(
                ref[i][1][k], rel=STEP_RTOL if i == 0 else DRIFT_RTOL)
    want = ref[n_steps - 1][0]
    assert int(st["step"]) == int(st["opt"]["step"]) == n_steps
    flips = total = 0
    for a, w in zip(leaves(st["params"]), jax.tree.leaves(want["params"])):
        d = np.abs(t2n(a) - w)
        flips += int((d > PARAM_ATOL[n_steps]).sum())
        total += d.size
        assert d.max() <= 2 * lr
    assert flips <= FLIP_SHARE * total, (flips, total)
    for k in ("m", "v"):
        assert _grad_rel(leaves(st["opt"][k]), jax.tree.leaves(
            want["opt"][k])) <= MOMENT_TOL[n_steps], k


def test_train_state_conversion_checks_the_tree():
    init = jax.tree.map(np.asarray, j_init_state(
        jconfigs.get_smoke("llama3p2_1b"), jax.random.PRNGKey(0),
        grad_compress=True))
    cfg = configs.get_smoke("llama3p2_1b")
    st = train_state_from_numpy(init, cfg, device=CPU)
    assert sorted(st) == ["ef", "opt", "params", "step"]
    assert st["opt"]["step"].dtype == torch.int32
    assert [x.shape for x in leaves(st["ef"])] == \
        [x.shape for x in leaves(st["params"])]
    bad = dict(init, opt=dict(init["opt"], m={"embed": init["opt"]["m"][
        "embed"]}))
    with pytest.raises(ValueError, match="opt/m does not mirror"):
        train_state_from_numpy(bad, cfg, device=CPU)


def test_loss_decreases_through_the_port():
    """The reference's ``test_loss_decreases``: llama3.2-1b smoke trained
    120 steps on the synthetic corpus (8 x 64, warmup_cosine to 5e-3)
    ends below 5.40 nll (uniform is ln 256 = 5.545); with gradient
    compression on, the nll also falls."""
    cfg = configs.get_smoke("llama3p2_1b")
    lr = functools.partial(warmup_cosine, peak_lr=5e-3, warmup=10, total=120)
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), batch=8, seq=64,
                    device=CPU)
    st = init_train_state(cfg, seed=0, device=CPU)
    step = make_train_step(cfg, lr_fn=lr)
    for i in range(120):
        st, m = step(st, dl.batch_at(i))
    assert float(m["nll"]) < 5.40
    st = init_train_state(cfg, seed=0, grad_compress=True, device=CPU)
    step = make_train_step(cfg, lr_fn=functools.partial(
        warmup_cosine, peak_lr=5e-3, warmup=5, total=60), grad_compress=True)
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=3), batch=8, seq=64,
                    device=CPU)
    first = None
    for i in range(60):
        st, m = step(st, dl.batch_at(i))
        first = float(m["nll"]) if first is None else first
    assert float(m["nll"]) < first - 0.05, (first, float(m["nll"]))


# ------------------------------------------------------------ decode oracle

HI_POL = QuantPolicy(bits_k=8.0, bits_v=8.0, group_size=16, window=8,
                     n_sink=2, fp8_meta=False)
DECODE_FAMILIES = ["llama3p2_1b", "gemma2_27b", "gemma3_4b", "hymba_1p5b",
                   "rwkv6_3b", "seamless_m4t_large_v2", "qwen2_vl_7b",
                   "granite_moe_1b_a400m"]


@pytest.mark.parametrize("arch", DECODE_FAMILIES)
def test_decode_matches_forward(arch):
    """The port's mirror of ``tests/test_serve.py::test_decode_matches_
    forward``: prefill + one decode step at 8 bits against the port's own
    ``forward_train``, with the reference test's bounds."""
    cfg = configs.get_smoke(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)     # dropless
    params = T.init_params(cfg, seed=1, device=CPU)
    rng = np.random.default_rng(0)
    b, s = 2, 24
    _, batch = _batch(cfg, rng, b, s + 1)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_embeds"] = batch["enc_embeds"]
    if cfg.input_embeds:
        pre = dict(tokens=None, embeds=batch["embeds"][:, :s], **kw)
        nxt = dict(token=None, embeds=batch["embeds"][:, s:s + 1])
    else:
        pre = dict(tokens=batch["tokens"][:, :s], **kw)
        nxt = dict(token=batch["tokens"][:, s:s + 1])
    ref, _ = T.forward_train(params, cfg, batch)
    l0, caches = T.prefill_model(params, cfg, policy=HI_POL, max_len=s + 8,
                                 **pre)
    np.testing.assert_allclose(t2n(l0[:, 0]), t2n(ref[:, s - 1]),
                               atol=2e-3, rtol=1e-3)
    l1, _ = T.decode_step(params, cfg, caches=caches, policy=HI_POL, **nxt)
    scale = float(ref.abs().max())
    err = float((l1[:, 0] - ref[:, s]).abs().max())
    assert err < 0.05 * max(scale, 1.0) + 0.02, (arch, err, scale)


# ------------------------------------------------------------ CLI

MASK = [(re.compile(r"loss \d+\.\d+"), "loss X"),
        (re.compile(r"gnorm \d+\.\d+ \d+ms"), "gnorm X")]


def _lines(out):
    for pat, rep in MASK:
        out = pat.sub(rep, out)
    return [ln for ln in out.splitlines() if ln.strip()]


def test_trainer_cli_lines_equal_the_reference_cli(capsys, tmp_path):
    """``--smoke --steps 3`` through both CLIs: the same lines (steps,
    lr, the done line) with loss, grad norm and ms masked; then the port's
    CLI resumes the reference CLI's checkpoints (same layout) and prints
    the reference's resume line."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    jdir = str(tmp_path / "ckpt")
    handler = signal.getsignal(signal.SIGTERM)   # both CLIs install one
    try:
        jtrain.main(["--smoke", "--steps", "3", "--ckpt-dir", jdir,
                     "--save-every", "2"])
        want = _lines(capsys.readouterr().out)
        ttrain.main(["--smoke", "--steps", "3", "--device", CPU])
        got = _lines(capsys.readouterr().out)
        assert got == want and len(want) == 3, (got, want)
        state = ttrain.main(["--smoke", "--steps", "4", "--device", CPU,
                             "--ckpt-dir", jdir, "--save-every", "2",
                             "--log-every", "1"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[resume] from step 2" and out[1].startswith(
        "step     3 loss ")
    assert int(state["step"]) == 4


class _Preempted(Exception):
    """The process dying after its SIGTERM save."""


def test_trainer_cli_resumes_a_sigterm_save_exactly(capsys, tmp_path,
                                                    monkeypatch):
    """SIGTERM after step 3 of a fresh 6-step run (a periodic save at step
    0 on disk), then the process dies before step 4: the hook's save is
    labelled step 3, the rerun prints ``[resume] from step 3`` and steps 4
    and 5, and its state and step lines (ms masked) equal an
    uninterrupted run's bitwise."""
    from repro_torch.launch import train as ttrain
    argv = ["--smoke", "--steps", "6", "--device", CPU, "--log-every", "1",
            "--save-every", "50"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
    loader = ttrain.DataLoader

    class Preempting(loader):
        def batch_at(self, step):
            if step == 4:
                os.kill(os.getpid(), signal.SIGTERM)     # the hook saves
                raise _Preempted
            return super().batch_at(step)

    handler = signal.getsignal(signal.SIGTERM)
    try:
        want = ttrain.main(argv)
        whole = capsys.readouterr().out.splitlines()
        monkeypatch.setattr(ttrain, "DataLoader", Preempting)
        with pytest.raises(_Preempted):
            ttrain.main(argv + ckpt)
        capsys.readouterr()
        monkeypatch.setattr(ttrain, "DataLoader", loader)
        got = ttrain.main(argv + ckpt)
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000000", "step_00000003"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[resume] from step 3"

    def steps(lines):      # the step lines, ms masked
        return [re.sub(r" \d+ms$", " Xms", ln) for ln in lines
                if ln.startswith("step ")]
    assert steps(out) == steps(whole)[4:] and len(steps(out)) == 2
    assert int(got["step"]) == 6
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
