"""The port's Table 6 suite (``repro_torch.speed.memory_latency``) and
its filler, the kernel suite's packed rows and ragged-occupancy sweep
(``repro_torch.speed.kernel_bench``), and the speed CLI (``python -m
repro_torch.speed``) against the reference harness
(``benchmarks/memory_latency.py``, ``kv_cache.prefill``,
``kernels/ops.decode_block_report``) on the CPU.

Tolerances, and why:

* the analytic rows: EXACT, string for string, with both sides under the
  same constants (the reference's v5e ones, then the H100's patched into
  both modules at test time);
* block reports (visited, capacity, bytes a block): EXACT;
* bytes a token and the filler's cache: EXACT (codes and fp8 scale/zero
  bytes, sink and window values, lengths): the filler quantizes each
  token row on its own, whatever the chunking;
* the SDPA yardstick against the port's fp16 route: relative L2 2e-2 on
  one step's logits (bf16 attention in SDPA against the route's f32
  partials over bf16 values).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import memory_latency as JM                # noqa: E402
from repro import configs as jconfigs                      # noqa: E402
from repro.core import kv_cache as jkvc                    # noqa: E402
from repro.core.policy import PAPER_POLICY as J_PAPER      # noqa: E402
from repro.core.policy import QuantPolicy as JPolicy       # noqa: E402
from repro.kernels.ops import decode_block_report as j_report  # noqa: E402

from repro_torch import configs                            # noqa: E402
from repro_torch.core.policy import (FP16_POLICY, PAPER_POLICY,  # noqa: E402
                                     QuantPolicy)
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.launch import roofline as RL              # noqa: E402
from repro_torch.models import transformer as T            # noqa: E402
from repro_torch.speed import __main__ as CLI              # noqa: E402
from repro_torch.speed import common as C                  # noqa: E402
from repro_torch.speed import kernel_bench as KB           # noqa: E402
from repro_torch.speed import memory_latency as ML         # noqa: E402
from test_torch_util import assert_tree_exact              # noqa: E402
from test_torch_util import (  # noqa: F401,E402
    jax_compile_cache, one_torch_thread)

CPU = "cpu"
SDPA_REL_TOL = 2e-2
J_KV4 = JPolicy(bits_k=4.0, bits_v=4.0, group_size=128, fp8_meta=True)


def _rows(fn, *args, **kw):
    out = []
    fn(out.append, *args, **kw)
    return out


@pytest.mark.parametrize("constants", ["reference", "h100"])
def test_analytic_rows_equal_the_reference(monkeypatch, constants):
    """Every analytic row, name and fields, string for string, with both
    modules under one set of constants."""
    peak, bw = ((JM.PEAK, JM.BW) if constants == "reference"
                else (RL.PEAK_FLOPS, RL.HBM_BW))
    for mod in (JM, ML):
        monkeypatch.setattr(mod, "PEAK", peak)
        monkeypatch.setattr(mod, "BW", bw)
    got = _rows(ML.analytic_rows)
    want = _rows(JM.run)
    assert got == want
    assert len(got) == 18


def test_analytic_rows_on_the_h100_constants():
    """The port's own constants are the H100's, and its max-context rows
    are the paper's 1M-token claim: kv2 1.02M, kv4 0.48M, fp16 0.12M."""
    assert (ML.PEAK, ML.BW) == (989e12, 3.35e12)
    rows = {r.split(",", 1)[0]: r for r in _rows(ML.analytic_rows)}
    assert rows["table6_max_context_kv2"].endswith("max_tokens=1.02M")
    assert rows["table6_max_context_kv4"].endswith("max_tokens=0.48M")
    assert rows["table6_max_context_fp16"].endswith("max_tokens=0.12M")
    assert "speedup_kv2=3.77x" in rows["table6_b1_s131072"]
    # the v5e rows are not the port's
    assert _rows(ML.analytic_rows) != _rows(JM.run)


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("pol", ["fp16", "kv4", "kv2"])
def test_bytes_per_token_equal_the_reference(arch, pol):
    tpol = {"fp16": None, "kv4": ML.KV4, "kv2": PAPER_POLICY}[pol]
    jpol = {"fp16": None, "kv4": J_KV4, "kv2": J_PAPER}[pol]
    assert ML._kv_bytes_per_token(configs.get(arch), tpol) == \
        JM._kv_bytes_per_token(jconfigs.get(arch), jpol)


def test_bytes_per_token_of_llama2_7b():
    """The headline arithmetic: 63,488 B a token at PAPER_POLICY (34 B of
    K and 28 B of V a head a layer), 135,168 at KV4, 524,288 in bf16;
    1,048,576 tokens of PAPER_POLICY planes take 66.57e9 B."""
    cfg = configs.get("llama2_7b")
    per = {k: ML._kv_bytes_per_token(cfg, p) * cfg.n_layers
           for k, p in (("kv2", PAPER_POLICY), ("kv4", ML.KV4),
                        ("fp16", None))}
    assert per == {"kv2": 63488, "kv4": 135168, "fp16": 524288}
    assert round(per["kv2"] * ML.HEADLINE / 1e9, 2) == 66.57


def _numpy_kv(cfg, n_layers, s, seed=5):
    rng = np.random.default_rng(seed)
    shape = (n_layers, 1, s, cfg.n_kv_heads, cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _policies(cfg):
    gs = min(32, cfg.head_dim)
    return {"kv2": QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=gs,
                               window=16, n_sink=4),
            "kv4": QuantPolicy(bits_k=4.0, bits_v=4.0, group_size=gs,
                               window=16, n_sink=4),
            "fp16": FP16_POLICY}


def _jpolicy(p):
    return JPolicy(bits_k=p.bits_k, bits_v=p.bits_v, group_size=p.group_size,
                   window=p.window, n_sink=p.n_sink, fp8_meta=p.fp8_meta,
                   clip=p.clip, reorder=p.reorder)


@pytest.mark.parametrize("chunk", [64, 1000])
@pytest.mark.parametrize("pol", ["kv2", "kv4", "fp16"])
def test_filler_builds_the_reference_prefill_cache(chunk, pol):
    """The filler's cache, layer by layer, against the reference's
    ``kv_cache.prefill`` from the same bf16 K/V (smoke llama3.2-1b, 300
    tokens, capacity 340, chunks of 64 and of 1000 tokens): every leaf
    exact."""
    cfg = configs.get_smoke("llama3p2_1b")
    tpol = _policies(cfg)[pol]
    s, max_len = 300, 340
    ks, vs = _numpy_kv(cfg, cfg.n_layers, s)
    tk = torch.as_tensor(ks).to(torch.bfloat16)
    tv = torch.as_tensor(vs).to(torch.bfloat16)
    caches = ML.fill_caches(
        cfg, tpol, s, max_len,
        lambda layer, t0, n: (tk[layer][:, t0:t0 + n],
                              tv[layer][:, t0:t0 + n]),
        chunk=chunk, device=CPU)
    for layer in range(cfg.n_layers):
        want = jkvc.prefill(jnp.asarray(ks[layer], jnp.bfloat16),
                            jnp.asarray(vs[layer], jnp.bfloat16), max_len,
                            _jpolicy(tpol))
        got = {k: t[layer] for k, t in caches["scan"].items()}
        assert_tree_exact(got, want, f"layer {layer}")


def test_alloc_caches_has_prefill_models_layout():
    """The filler's tree, shapes and dtypes are ``prefill_model``'s."""
    cfg = configs.get_smoke("llama2_7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=CPU)
    pol = _policies(cfg)["kv2"]
    _, want = T.prefill_model(params, cfg, torch.zeros((1, 40),
                                                       dtype=torch.int64),
                              pol, max_len=96)
    got = ML.alloc_caches(cfg, 96, pol, device=CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got["scan"].items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in want["scan"].items()}
    assert ML.cache_nbytes(cfg, 96, pol) == T.cache_bytes(got)


def test_seeded_kv_is_a_function_of_layer_and_offset():
    cfg = configs.get_smoke("llama2_7b")
    src = ML.seeded_kv(cfg, 3, CPU)
    a, b = src(1, 64, 32), src(1, 64, 32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (1, 32, cfg.n_kv_heads, cfg.head_dim)
    assert a[0].dtype == torch.bfloat16
    assert not torch.equal(src(0, 64, 32)[0], a[0])
    assert not torch.equal(src(1, 0, 32)[0], a[0])


@pytest.fixture(scope="module")
def smoke_params():
    cfg = configs.get_smoke("llama2_7b")
    return cfg, T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=CPU)


@pytest.mark.parametrize("label", [p[0] for p in ML.POLICIES])
def test_measure_runs_every_policy_on_the_cpu(smoke_params, label):
    """A measured row on the CPU (the plain versions, host times): fills,
    steps eagerly and through the graph cache, counts its bound, and
    every step appended one token."""
    cfg, params = smoke_params
    _, pol, bk = next(p for p in ML.POLICIES if p[0] == label)
    r = ML.measure(params, cfg, pol, 96, device=CPU, backend=bk,
                   replays=2, repeats=1)
    assert r["fits"] and r["finite"]
    # one untimed + 3 timed eager steps, 1 + 2 timed replays, one more
    # replay for the logits, one counted step
    assert r["length_after"] - 96 == 1 + ML.EAGER_STEPS + 3 + 1 + 1
    assert r["bound_ms"] > 0 and r["bound_by"] in ("memory", "compute")
    assert r["cache_bytes"] == ML.cache_nbytes(cfg, 96 + ML.HEADROOM, pol)
    assert r["replayed_ms"]["n"] == 1 and r["eager_ms"]["n"] == 3
    rows = _rows(ML.measured_row, label, r, 1.0)
    assert rows[0].startswith(f"table6_measured_b1_s96_{label},")
    assert ",fits=true," in rows[0] and "analytic_ms=1.000" in rows[0]


def test_measure_reports_what_does_not_fit(monkeypatch, smoke_params):
    """A cache larger than the free memory, or a step that runs out of it,
    gives ``fits=false`` with the bytes needed; nothing raises."""
    cfg, params = smoke_params
    monkeypatch.setattr(ML, "_free_bytes", lambda dev: 1000)
    r = ML.measure(params, cfg, PAPER_POLICY, 96, device=CPU)
    assert (r["fits"], r["where"]) == (False, "cache")
    assert r["need_bytes"] == r["cache_bytes"] + r["weight_bytes"]
    row = _rows(ML.measured_row, "kv2", r, None)[0]
    assert ",fits=false,where=cache," in row
    assert f"need_bytes={r['need_bytes']}" in row
    monkeypatch.setattr(ML, "_free_bytes", lambda dev: None)

    def oom(*a, **k):
        raise torch.OutOfMemoryError("out of memory")
    monkeypatch.setattr(ML.T, "decode_step", oom)
    r = ML.measure(params, cfg, PAPER_POLICY, 96, device=CPU)
    assert (r["fits"], r["where"]) == (False, "step")


def test_sdpa_yardstick_matches_the_fp16_route(smoke_params):
    """One decode step over the same fp16 cache through
    ``SdpaBackend`` and through the port's fp16 route."""
    cfg, params = smoke_params
    src = ML.seeded_kv(cfg, 0, CPU)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    out = {}
    for name, bk in (("route", "cuda"), ("sdpa", ML.SdpaBackend())):
        caches = ML.fill_caches(cfg, FP16_POLICY, 200, 256, src, device=CPU)
        out[name] = T.decode_step(params, cfg, tok, caches, FP16_POLICY,
                                  backend=bk)[0].float()
    rel = float((out["sdpa"] - out["route"]).norm() / out["route"].norm())
    assert rel <= SDPA_REL_TOL, rel
    with pytest.raises(ValueError, match="fp16"):
        T.decode_step(params, cfg, tok, ML.fill_caches(
            cfg, PAPER_POLICY, 200, 256, src, device=CPU), PAPER_POLICY,
            backend=ML.SdpaBackend())


def test_run_on_the_cpu_gives_the_smoke_rehearsal():
    rows = _rows(ML.run, device=CPU)
    names = [r.split(",", 1)[0] for r in rows]
    assert names[:18] == [r.split(",", 1)[0] for r in _rows(JM.run)]
    for s in ML.SMOKE_CONTEXTS:
        for label, _, _ in ML.POLICIES:
            row = rows[names.index(f"table6_measured_b1_s{s}_{label}")]
            assert ",fits=true," in row and "finite=True" in row
            assert "analytic_ms=n/a" in row          # not the analytic model
        assert f"table6_measured_speedup_b1_s{s}" in names


def _names(rows):
    return [r.split(",", 1)[0] for r in rows]


def test_ragged_reports_equal_the_reference():
    """Blocks visited, capacity blocks and bytes a block of the sweep's
    caches at cap 512, global and local (window bs + 8), against the
    reference's ``decode_block_report`` on the same K/V; the gate row."""
    rows = []
    got = KB._bench_ragged_occupancy(rows.append, True, CPU)
    rng = np.random.default_rng(3)
    hkv, hq, d, bs, b = 2, 4, 64, 64, 2
    pol = JPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=16, n_sink=4)
    max_len = 512 + pol.n_sink + pol.window
    for occ in (0.01, 0.25, 1.0):
        length = max(1, int(round(512 * occ))) + pol.n_sink + pol.window
        k = jnp.asarray(rng.normal(size=(b, length, hkv, d)), jnp.float32)
        v = jnp.asarray(rng.normal(size=(b, length, hkv, d)), jnp.float32)
        cache = jkvc.prefill(k, v, max_len, pol)
        rng.normal(size=(b, 1, hq, d))                     # q
        for lname, w in (("global", None), ("local", jnp.int32(bs + 8))):
            rep = j_report(cache, pol, d, window=w, block_s=bs)
            want = {"visited": int(np.asarray(rep["visited"]).sum()),
                    "total": b * rep["total"],
                    "bytes_per_block": rep["bytes_per_block"]}
            assert {k: got[(occ, lname)][k] for k in want} == want, \
                (occ, lname)
    assert got[(0.25, "global")]["reduction"] >= KB.PRUNE_GATE
    assert _names(rows) == ["kernel_backend_info"] + [
        f"kernel_ragged_occ{o}pct_{k}" for o in (1, 25, 100)
        for k in ("global", "local")] + ["kernel_ragged_prune_gate"]
    assert all("occupancy=" in r for r in rows[1:])


def test_ragged_suite_raises_when_the_gate_fails(monkeypatch):
    """A report that prunes nothing fails the sweep's hard gate."""
    real = ops.decode_block_report

    def unpruned(cache, policy, head_dim, **kw):
        rep = real(cache, policy, head_dim, **kw)
        return dict(rep, visited=torch.full_like(rep["visited"],
                                                 rep["total"]))
    monkeypatch.setattr(ops, "decode_block_report", unpruned)
    with pytest.raises(AssertionError, match="block pruning regressed"):
        KB._bench_ragged_occupancy(lambda r: None, True, CPU)
    with pytest.raises(AssertionError):
        KB.check_prune_gate(3.99)
    KB.check_prune_gate(4.0)


def test_packed_rows_count_the_tensors_bytes(monkeypatch):
    """``kernel_bench.run``'s packed-vs-fp16 rows (the sweep and the
    backends left out): cache bytes from the tensors, the kernel's
    output against fp attention over the dequantized tokens."""
    for name in ("_bench_ragged_occupancy", "_bench_decode_step_backends"):
        monkeypatch.setattr(KB, name, lambda *a, **k: None)
    rows = _rows(KB.run, True, CPU)
    f16, packed, win = rows
    s, cache16 = 512, 2 * KB.B * 512 * KB.H * KB.D * 2
    assert f16.startswith("kernel_fp16_attn,") and \
        f"cache_bytes={cache16}" in f16
    # K 2-bit: 32 code bytes + 2 fp8 bytes a row; V 1.5-bit: 24 + 4
    cacheq = KB.B * s * KB.H * (34 + 28)
    assert f"cache_bytes={cacheq}," in packed
    assert f"cache_compression={cache16 / cacheq:.2f}x" in packed
    err = float(packed.split("max_abs_err_vs_dequantized=")[1])
    assert err < 1e-4
    assert win.startswith("kernel_hbm_win,0.0,operand_reduction=")


def test_csv_row_is_the_reference_format():
    from benchmarks import common as JC
    assert C.csv_row("a", 12.345, "x=1,y=2") == JC.csv_row("a", 12.345,
                                                           "x=1,y=2")
    assert C.timed(lambda: None, CPU, iters=3, repeats=2)["n"] == 2


def test_cli_writes_the_table6_rows(tmp_path, capsys):
    path = tmp_path / "t6.json"
    rc = CLI.main(["--only", "table6", "--device", "cpu", "--json",
                   str(path)])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu" and out[1] == C.HEADER
    data = json.loads(path.read_text())
    assert data["device"] == "cpu" and data["failures"] == []
    want = _rows(ML.analytic_rows)
    got = [f"{r['name']},{r['us_per_call']:.1f},{r['derived']}"
           for r in data["rows"][:18]]
    assert got == want
    assert out[2:20] == want
    assert any(r["name"] == "table6_measured_b1_s320_kv2"
               for r in data["rows"])


def test_cli_reports_a_failing_suite_and_exits_1(monkeypatch, capsys,
                                                 tmp_path):
    def ok(emit, device=None):
        emit("ok_row,1.0,x=1")

    def broken(emit, smoke=False, device=None):
        raise RuntimeError("gate")
    monkeypatch.setitem(CLI.SUITES, "table6", broken)
    monkeypatch.setitem(CLI.SUITES, "kernel", ok)
    path = tmp_path / "f.json"
    rc = CLI.main(["--only", "table6,kernel", "--device", "cpu", "--json",
                   str(path)])
    out = capsys.readouterr()
    assert rc == 1
    assert "table6_FAILED,0.0,RuntimeError" in out.out
    assert "ok_row,1.0,x=1" in out.out           # the others still ran
    assert "# FAILED table6" in out.err
    assert json.loads(path.read_text())["failures"][0]["suite"] == "table6"
    with pytest.raises(SystemExit):
        CLI.main(["--only", "nope", "--device", "cpu"])
