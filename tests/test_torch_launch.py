"""The port's analytic launch path held to the JAX package on the CPU:
``configs/shapes.py``, ``launch/op_cost.py`` (against
``launch/jaxpr_cost.py``), ``launch/roofline.py``'s ``model_flops``,
``launch/report.py``, the kernel entry points' reported costs, and the
mixed-precision (bf16) train step.

Tolerances, and why:

* shapes, input specs, cache specs and ``model_flops``: exact (the same
  integers and dtypes, the same float expression).
* matmul FLOPs, op_cost against jaxpr_cost: exact for the dense
  (llama3.2-1b) prefill, decode step and train step; the MoE
  (deepseek-moe-16b) counts differ by the named terms each test asserts.
  Total FLOPs and bytes differ by what each counter sees as one op (XLA's
  fused primitives against aten's decompositions), so they are printed side
  by side and held within TOTAL_RATIO of each other.
* the bf16 train step against the reference's ``compute_dtype=bf16``
  step: loss, nll and grad norm within BF16_RTOL relative (measured 1.8e-5
  on the loss, 6.2e-4 on the grad norm: XLA's CPU backend keeps each
  fusion's elementwise chain in f32 and rounds at its outputs, where torch
  rounds every op's output to bf16); every param within 2 x lr of the
  reference's (AdamW's first step moves a weight by lr times the sign of
  its gradient, so a sign flip moves it 2 x lr), and at most FLIP_SHARE
  of them past 1e-4 (measured 0.43%).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import shapes as jshp
from repro.core.policy import PAPER_POLICY as J_PAPER
from repro.core.policy import QuantPolicy as JPolicy
from repro.launch import jaxpr_cost as JC
from repro.launch import report as jrep
from repro.launch import roofline as JRL
from repro.models import transformer as JT
from repro.training import init_train_state as j_init_state
from repro.training import make_train_step as j_make_step

from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core.policy import PAPER_POLICY, QuantPolicy
from repro_torch.kernels import decode_attn as kda
from repro_torch.kernels import kv_quant as kkq
from repro_torch.launch import op_cost as OC
from repro_torch.launch import report as trep
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as T
from repro_torch.training import make_train_step
from repro_torch.tree import leaves
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ARCHS
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
TOTAL_RATIO = 1.5
BF16_RTOL = 2e-3
FLIP_SHARE = 1e-2
LR = 5e-3


# ----------------------------------------------------------- shapes

def test_shape_tables_equal_the_reference():
    assert shp.SHAPES == jshp.SHAPES
    assert shp.SKIPS == jshp.SKIPS
    assert shp.LONG_OK == jshp.LONG_OK
    for a in ARCHS:
        for s in shp.SHAPES:
            assert shp.cell_is_skipped(a, s) == jshp.cell_is_skipped(a, s)
    for sl in (1, 4096, 32768, 524288):
        for pol in (PAPER_POLICY, QuantPolicy(**KW)):
            jpol = J_PAPER if pol is PAPER_POLICY else JPolicy(**KW)
            assert shp.serve_max_len(sl, pol) == jshp.serve_max_len(sl, jpol)


def _same_spec(got, want, what):
    assert got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for s in shp.SHAPES:
        for fn in ("train_input_specs", "prefill_input_specs"):
            got = getattr(shp, fn)(cfg, s)
            want = getattr(jshp, fn)(jcfg, s)
            assert sorted(got) == sorted(want), (arch, s, fn)
            for k in want:
                _same_spec(got[k], want[k], (arch, s, fn, k))
        _same_spec(shp.decode_token_spec(cfg, s),
                   jshp.decode_token_spec(jcfg, s), (arch, s))


def _reference_cache_specs(jcfg, shape):
    params = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jshp.decode_cache_specs(jcfg, shape, J_PAPER, params)


def _merged_groups(tree):
    """The reference's caches with its ``dense`` group (the first_dense
    layers of an MoE config) stacked before ``scan``, as the port keeps
    one group over every layer."""
    groups = {k: dict(v) for k, v in tree.items()}
    if "dense" in groups:
        dense = groups.pop("dense")
        groups["scan"] = {
            k: jax.ShapeDtypeStruct((v.shape[0] + dense[k].shape[0],)
                                    + v.shape[1:], v.dtype)
            for k, v in groups["scan"].items()}
    return groups


def _cache_cases():
    out = [(a, "decode_32k", True) for a in ARCHS]
    out += [(a, "long_500k", True) for a in shp.LONG_OK]
    return out + [("llama3p2_1b", "decode_32k", False)]


@pytest.mark.parametrize("arch,shape,smoke", _cache_cases())
def test_decode_cache_specs_equal_the_reference(arch, shape, smoke):
    get = "get_smoke" if smoke else "get"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    got = shp.decode_cache_specs(cfg, shape, PAPER_POLICY)
    want = _merged_groups(_reference_cache_specs(jcfg, shape))
    assert sorted(got) == sorted(want)
    for g in want:
        assert sorted(got[g]) == sorted(want[g]), (arch, g)
        for k in want[g]:
            _same_spec(got[g][k], want[g][k], (arch, shape, g, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for s in shp.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            args = (kind, s["global_batch"], s["seq_len"])
            assert RL.model_flops(cfg, *args) == JRL.model_flops(jcfg, *args)


# ------------------------------------------------- op_cost vs jaxpr_cost

def _jaxpr_dot_flops(jaxpr) -> float:
    """``jaxpr_cost``'s walk counting dot_general FLOPs alone."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0.0
    for eqn in jaxpr.eqns:
        prim, p = eqn.primitive.name, eqn.params
        if prim == "scan":
            total += float(p["length"]) * _jaxpr_dot_flops(p["jaxpr"])
        elif prim == "while":
            total += _jaxpr_dot_flops(p["body_jaxpr"])
        elif prim == "cond":
            total += max(_jaxpr_dot_flops(b) for b in p["branches"])
        elif "jaxpr" in p:
            total += _jaxpr_dot_flops(p["jaxpr"])
        elif "call_jaxpr" in p:
            total += _jaxpr_dot_flops(p["call_jaxpr"])
        elif prim == "dot_general":
            total += JC._dot_flops(eqn)
    return total


def _costs(jfn, jargs, tfn, targs):
    """(reference matmul FLOPs, port matmul FLOPs, reference totals, port
    totals, the port's counts by category)."""
    jaxpr = jax.make_jaxpr(jfn)(*jargs)
    jdot = _jaxpr_dot_flops(jaxpr)
    jtot = JC.jaxpr_cost(jaxpr)
    with OC.OpCounter() as c:
        tfn(*targs)
    return jdot, c.counts.get("matmul", {}).get("flops", 0.0), jtot, \
        c.totals(), c.counts


def _pair(arch, rng):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _report(what, jtot, ttot):
    print(f"{what}: flops jaxpr {jtot['flops']:.4e} op_cost "
          f"{ttot['flops']:.4e}; bytes jaxpr {jtot['bytes']:.4e} op_cost "
          f"{ttot['bytes']:.4e}")
    for k in ("flops", "bytes"):
        r = ttot[k] / jtot[k]
        assert 1 / TOTAL_RATIO <= r <= TOTAL_RATIO, (what, k, r)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "deepseek_moe_16b"])
def test_op_cost_matmuls_equal_jaxpr_cost(arch, rng):
    jcfg, cfg, jp, tp = _pair(arch, rng)
    toks = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jpol, pol = JPolicy(**KW), QuantPolicy(**KW)
    # prefill
    jfn = lambda p, t: JT.prefill_model(p, jcfg, {"tokens": t}, jpol,
                                        max_len=64)
    tfn = lambda p, t: T.prefill_model(p, cfg, t, pol, max_len=64,
                                       backend="reference")
    with torch.no_grad():
        jd, td, jtot, ttot, by = _costs(jfn, (jp, jnp.asarray(toks)), tfn,
                                        (tp, torch.from_numpy(toks)))
    _report(f"{arch} prefill", jtot, ttot)
    pre = (jd, td)
    # one decode step from the prefilled caches
    _, jc = JT.prefill_model(jp, jcfg, {"tokens": jnp.asarray(toks)}, jpol,
                             max_len=64)
    with torch.no_grad():
        _, tc = T.prefill_model(tp, cfg, torch.from_numpy(toks), pol,
                                max_len=64, backend="reference")
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    jfn = lambda p, t, c: JT.decode_step(p, jcfg, t, c, jpol)
    tfn = lambda p, t, c: T.decode_step(p, cfg, t, c, pol,
                                        backend="reference")
    with torch.no_grad():
        jd, td, jtot, ttot, _ = _costs(jfn, (jp, jnp.asarray(tok), jc), tfn,
                                       (tp, torch.from_numpy(tok), tc))
    _report(f"{arch} decode", jtot, ttot)
    dec = (jd, td)
    # one train step, remat off
    jcfg_t = dataclasses.replace(jcfg, remat=False)
    cfg_t = dataclasses.replace(cfg, remat=False)
    jst = j_init_state(jcfg_t, jax.random.PRNGKey(0))
    st = train_state_from_numpy(jax.tree.map(np.asarray, jst), cfg_t,
                                device="cpu")
    lab = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(lab)}
    jd, td, jtot, ttot, _ = _costs(
        j_make_step(jcfg_t, lr_fn=lambda s: jnp.float32(LR)), (jst, jb),
        make_train_step(cfg_t, lr_fn=lambda s: LR), (st, tb))
    _report(f"{arch} train", jtot, ttot)
    trn = (jd, td)
    print(f"{arch} matmul flops (jaxpr, op_cost): prefill {pre} decode "
          f"{dec} train {trn}")
    if not cfg.is_moe:
        assert pre[0] == pre[1] and dec[0] == dec[1] and trn[0] == trn[1]
        return
    # the MoE gap: two products the reference writes as einsums
    # (dot_generals) and the port as elementwise ops, each 2·T·k·E FLOPs a
    # MoE layer: the int32 ``einsum("gtke,gtke->gtk", pos, oh_i)`` that
    # picks each slot's position, and the first contraction of the
    # three-operand combine ``einsum("gtk,gtke,gtkc->gtec", w_g, oh_e,
    # oh_c)`` (w_g times oh_e, no contracted dim); the train step's backward
    # adds the combine's gradient for w_g (the position product has none)
    for what, (jv, tv), n_tok, n_terms in (("prefill", pre, 80, 2),
                                           ("decode", dec, 2, 2),
                                           ("train", trn, 80, 3)):
        term = (2.0 * n_tok * jcfg.top_k * jcfg.n_experts
                * (jcfg.n_layers - jcfg.first_dense))
        assert jv - tv == n_terms * term, (what, jv, tv, term)


# ------------------------------------------------- kernel entry points

def _kernel_only(c, name):
    assert set(c.counts) == {f"kernel:{name}"}, c.counts
    got = c.counts[f"kernel:{name}"]
    return got["flops"], got["bytes"]


def test_kernel_entry_points_report_their_formula(rng):
    pol = QuantPolicy(**KW)
    x = torch.from_numpy(rng.normal(size=(48, 32)).astype(np.float32))
    with OC.OpCounter() as c:
        kkq.kv_quant(x, 2.0, 16)
    assert _kernel_only(c, "kv_quant") == kkq.quant_cost(x, 2.0, 16)

    from repro_torch.core import kv_cache as kvc
    b, h, d = 3, 2, 32
    cache = kvc.init_cache(b, 44, h, d, pol, torch.float32, "cpu")
    cache["length"].copy_(torch.tensor([3, 12, 30], dtype=torch.int32))
    kn = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    want, vn = kkq.append_cost(cache, kn, pol), kn.clone()
    with OC.OpCounter() as c:
        kkq.kv_append(cache, kn, vn, pol)
    assert _kernel_only(c, "kv_append") == want
    # 2 of 3 slots evict (lengths 12 and 30 reach window + sinks)
    assert want[0] == 7.0 * 2 * 2 * h * d

    cache1 = kvc.init_cache(1, 44, h, d, pol, torch.float32, "cpu")
    kc = torch.from_numpy(rng.normal(size=(1, 16, h, d)).astype(np.float32))
    want, vc = kkq.chunk_cost(kc, pol, 0, 16), kc.clone()
    with OC.OpCounter() as c:
        kkq.kv_append_chunk(cache1, kc, vc, pol, 0, 16)
    assert _kernel_only(c, "kv_append_chunk") == want

    q = torch.from_numpy(rng.normal(size=(b, h, 2, d)).astype(np.float32))
    mask = torch.zeros((b, 64))
    mask[0, :5] = 1
    mask[2, 10:40] = 1
    k_qt = {kk[3:]: vv[:, :32] for kk, vv in cache.items()
            if kk.startswith("qk_")}
    v_qt = {kk[3:]: vv[:, :32] for kk, vv in cache.items()
            if kk.startswith("qv_")}
    want = kda.attn_cost(q, mask, pol, d)
    with OC.OpCounter() as c:
        kda.decode_attn(q, k_qt, v_qt, mask, pol, d, 0.1, block_s=32)
    assert _kernel_only(c, "decode_attn") == want
    assert want[0] == 35 * h * (4 * d + 4 * d * 2)


def test_kernel_cost_scales_inside_a_local_region():
    """A kernel called on a rank's shard (``sharding.run_local``) reports
    its cost times the region's shards, as a local op is counted."""
    from repro_torch.distributed import sharding as S
    with OC.OpCounter() as c:
        with S.local_scaled(4):
            with OC.kernel_cost("k", lambda: (2.0, 3.0)):
                torch.ones(3) + 1          # not counted: inside the kernel
            torch.ones(5) * 2              # counted x4
    assert c.counts["kernel:k"] == {"flops": 8.0, "bytes": 12.0, "ops": 1}
    assert c.counts["elementwise"]["flops"] == 20.0


def test_counter_conventions():
    a, b = torch.ones(3, 4, 5), torch.ones(3, 5, 6)
    with OC.OpCounter() as c:
        a @ b                                   # bmm
        a.reshape(12, 5)                        # a view: nothing
        torch.cat([a, a])                       # moves its output
        torch.exp(a)                            # 1 FLOP an element
    assert c.counts["matmul"]["flops"] == 2.0 * 3 * 4 * 6 * 5
    assert c.counts["matmul"]["bytes"] == 4.0 * (60 + 90 + 72)
    assert c.counts["move"] == {"flops": 0.0, "bytes": 4.0 * 120, "ops": 1}
    assert c.counts["elementwise"]["flops"] == 60.0


# ------------------------------------------------------------ report

def _rows():
    def ok(arch, shape, mesh, temp_gib, arg_gib, variant="base"):
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "variant": variant, "status": "ok", "compile_s": 3.0,
                "roofline": {"t_compute": 1.5e-3, "t_memory": 2.25e-2,
                             "t_collective": 4e-4, "dominant": "memory",
                             "useful_ratio": 0.8125,
                             "roofline_fraction": 0.0123},
                "memory": {"temp": int(temp_gib * 2 ** 30),
                           "argument": int(arg_gib * 2 ** 30)}}
    return [
        ok("llama3p2_1b", "decode_32k", "16x16", 1.0, 2.0),
        ok("gemma2_27b", "train_4k", "16x16", 4.0, 3.0),
        ok("gemma2_27b", "train_4k", "16x16", 2.0, 3.0, "remat_full"),
        ok("gemma2_27b", "decode_32k", "16x16", 90.0, 3.0),
        # 20 GiB: over the v5e's 16, under the H100's 80
        ok("deepseek_moe_16b", "train_4k", "16x16", 17.0, 3.0),
        {"arch": "llama3p2_1b", "shape": "long_500k", "mesh": "16x16",
         "variant": "base", "status": "skipped",
         "reason": jshp.SKIPS[("llama3p2_1b", "long_500k")]},
        {"arch": "hymba_1p5b", "shape": "prefill_32k", "mesh": "16x16",
         "variant": "base", "status": "error", "error": "ValueError: x"},
        ok("llama3p2_1b", "decode_32k", "2x16x16", 1.0, 2.0),
        {"arch": "llama3p2_1b", "shape": "train_4k", "mesh": "2x16x16",
         "variant": "base", "status": "error", "error": "E"},
    ]


def test_report_strings_equal_the_reference_but_fits():
    rows = _rows()
    got, want = trep.baseline_table(rows), jrep.baseline_table(rows)
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    differ = [(g, w) for g, w in zip(gl, wl) if g != w]
    # the one row between the two cards' memories
    assert len(differ) == 1
    g, w = differ[0]
    assert "deepseek_moe_16b" in g
    assert g.endswith("| yes |") and w.endswith("| **no** |")
    assert g[:-len("| yes |")] == w[:-len("| **no** |")]
    assert "gemma2_27b | decode_32k" in got and "**no**" in got
    for args in (("gemma2_27b", "train_4k"), ("gemma2_27b", "decode_32k"),
                 ("hymba_1p5b", "long_500k")):
        assert trep.variant_rows(rows, *args) == jrep.variant_rows(rows,
                                                                   *args)
    assert trep.multipod_check(rows) == jrep.multipod_check(rows) == (1, 0,
                                                                      1)
    assert trep.fmt_t(1.23456e-3) == jrep.fmt_t(1.23456e-3)


# ------------------------------------------------- bf16 train step

def test_bf16_train_step_matches_reference(rng):
    jcfg, cfg = jconfigs.get_smoke("llama3p2_1b"), configs.get_smoke(
        "llama3p2_1b")
    jst = j_init_state(jcfg, jax.random.PRNGKey(0))
    st = train_state_from_numpy(jax.tree.map(np.asarray, jst), cfg,
                                device="cpu")
    toks = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    jstep = jax.jit(j_make_step(jcfg, lr_fn=lambda s: jnp.float32(LR),
                                compute_dtype=jnp.bfloat16))
    jst2, jm = jstep(jst, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(lab)})
    step = make_train_step(cfg, lr_fn=lambda s: LR,
                           compute_dtype=torch.bfloat16)
    st2, m = step(st, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(lab)})
    for k in ("loss", "nll", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=BF16_RTOL), k
    # the knob changes the math: the f32 step's loss is another number,
    # and the forward's logits are bf16
    f32 = make_train_step(cfg, lr_fn=lambda s: LR)(
        st, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(lab)})[1]
    assert float(f32["loss"]) != float(m["loss"])
    logits, _ = T.forward_train(st["params"], cfg,
                                {"tokens": torch.from_numpy(toks)},
                                dtype=torch.bfloat16)
    assert logits.dtype == torch.bfloat16
    flips = total = 0
    for a, w in zip(leaves(st2["params"]),
                    jax.tree.leaves(jst2["params"])):
        assert a.dtype == torch.float32
        d = np.abs(a.detach().numpy() - np.asarray(w))
        assert d.max() <= 2 * LR
        flips += int((d > 1e-4).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)


# ------------------------------------------------------------ examples

EXAMPLES = [
    ("torch_quickstart.py", ["--steps", "8"],
     ("trained 8 steps", "calibrated 2 layers", "token agreement")),
    ("torch_long_context_serving.py", [],
     ("long request : prefilled 504 tokens, generated 8 (length)",
      "short request: prefilled 32 tokens, generated 16 (length)",
      "compression")),
    ("torch_train_end_to_end.py", ["--steps", "4"],
     ("done. straggler events:", "served (4, 24) tokens")),
    ("torch_method_comparison.py", ["--steps", "8"],
     ("8 training steps, cpu", "fp16 ", "rtn ", "smoothquant ", "rptq ",
      "kivi ", "skvq ")),
]


@pytest.mark.parametrize("name,extra,want", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_torch_examples_run_on_the_cpu(name, extra, want, tmp_path):
    """Each of the port's examples end to end on the CPU, at fewer
    training steps than its default."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    if name == "torch_train_end_to_end.py":
        extra = extra + ["--ckpt-dir", str(tmp_path / "ckpt")]
    if name == "torch_method_comparison.py":
        extra = extra + ["--cache-dir", str(tmp_path / "bench")]
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        "--device", "cpu", *extra], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    for w in want:
        assert w in r.stdout, (w, r.stdout[-2000:])
