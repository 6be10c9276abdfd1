"""The port's sharded serve path and its dry-run on the CPU.

* Eight gloo ranks (one subprocess spawning one process a rank, one torch
  thread each) on a (2, 2, 2) ``("pod", "data", "model")`` mesh run
  ``prefill_model`` + 4 ``decode_step``s (reference backend, f32) on
  DTensors placed by ``launch.shardings`` under each serve rule table:
  ``SERVE_RULES`` at batch 4 (batch over (pod, data), heads over model),
  ``REPL_SERVE_RULES`` and ``LONG_SERVE_RULES`` at batch 1 (the latter
  splits the packed region over the 4 data ranks, 8 packed tokens each:
  the 4 appends write packed tokens 22-25, crossing from the third
  rank's shard into the fourth, and each step merges the ranks' partials
  by logsumexp), and a head count the model axis does not divide (3 kv
  heads of 6 query heads over 2: the projections are gathered before
  the head split).  The unrolled step (``decode_step(unroll=True)``)
  runs on gemma3-4b and hymba-1.5b smoke configs (local window 8) under
  the three rule tables, at a policy window of 4 (so the pre-append
  order differs from the default step's) and ``max_len`` 40 (32 packed
  tokens again): under LONG_SERVE_RULES the hoisted slice crosses a
  shard boundary; gemma3's SERVE_RULES case runs once more on the cuda
  backend (its plain versions here).  The logits of every step are held
  to the one-device port's and (reference backend) to the reference's
  ``prefill_model`` / jitted ``decode_step`` from the same params and
  tokens; the ranks run while this process computes both.
  Tolerances: the one-device port's within ``atol = rtol = 1e-5`` (the
  same f32 math; the tensor-parallel products sum their halves in
  another order); the reference's within ``test_torch_model.py``'s 2e-4
  (torch and XLA sum matmuls in different orders).
* A fake world (``launch.dryrun``: 256 fake ranks, 16 x 16) traces one
  cell each of train, prefill and decode of the llama3.2-1b smoke config
  at the cells' shapes: rows with ``status == "ok"``, the long_500k cell
  skipped as ``SKIPS`` says, exit 0; beside it one cell of each variant
  group (``VARIANT_CELLS``: the unrolled step under each rule table, the
  chunked walk, the sequence-parallel train step) traces ok.
* The chunked packed walk: bitwise the host skip's when every tile is
  merged and a dead one discarded on the device, and the same shapes
  and dtypes on fake tensors.
"""
import functools
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as T
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PROMPT, MAX_LEN, STEPS = 34, 44, 4      # packed region 32 = 4 ranks x 8
PORT_TOL, REF_TOL = 1e-5, 2e-4
# (case, arch, heads override, rules, batch, unroll, backend)
CASES = [("serve", "llama3p2_1b", None, "SERVE_RULES", 4, False, "reference"),
         ("repl", "llama3p2_1b", None, "REPL_SERVE_RULES", 1, False,
          "reference"),
         ("long", "llama3p2_1b", None, "LONG_SERVE_RULES", 1, False,
          "reference"),
         ("uneven", "llama3p2_1b", (6, 3), "SERVE_RULES", 4, False,
          "reference")] + [
    (f"unroll_{arch}_{name}", arch, None, rules, b, True, "reference")
    for arch in ("gemma3_4b", "hymba_1p5b")
    for name, rules, b in (("serve", "SERVE_RULES", 4),
                           ("repl", "REPL_SERVE_RULES", 1),
                           ("long", "LONG_SERVE_RULES", 1))] + [
    ("unroll_gemma3_4b_serve_cuda", "gemma3_4b", None, "SERVE_RULES", 4,
     True, "cuda")]
# a context-parallel cache on the cuda backend: its decode step refuses
REFUSED = [("unroll_gemma3_4b_long_cuda", "gemma3_4b", None,
            "LONG_SERVE_RULES", 1, True, "cuda")]
# the unrolled cases: a policy window (4) shorter than the local window
# (8), so the pre-append order differs from the default step's, and a
# packed region of 32 = 4 ranks x 8 again
UNROLL_KW, UNROLL_MAX_LEN = dict(KW, window=4), 40
N_LOCAL = 8                         # packed tokens a rank under LONG rules
DEADLINE_S = 600


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _configs(arch, heads):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    if heads is not None:
        kw = dict(n_heads=heads[0], n_kv_heads=heads[1])
        jcfg, cfg = jcfg.scaled(**kw), cfg.scaled(**kw)
    return jcfg, cfg


_WORLD = textwrap.dedent('''
    import pickle, sys
    from pathlib import Path
    import torch

    def rank_main(rank, world, port, out):
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.convert import params_from_numpy
        from repro_torch.core.policy import QuantPolicy
        from repro_torch.distributed import sharding as S
        from repro_torch.launch.mesh import init_world, make_mesh
        from repro_torch.launch.shardings import (params_shardings, place,
                                                  token_sharding)
        from repro_torch.models import transformer as T
        init_world("cpu", init_method=f"tcp://localhost:{port}",
                   world_size=world, rank=rank)
        out = Path(out)
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        cases = pickle.load(open(out / "cases.pkl", "rb"))
        res = {}
        for name, c in cases.items():
            cfg, pol = c["cfg"], QuantPolicy(**c["kw"])
            tp = params_from_numpy(c["params"], cfg, device="cpu")
            params = place(tp, params_shardings(tp, mesh), mesh)
            rules = getattr(S, c["rules"])

            def tok(a):
                t = torch.from_numpy(a)
                return S.distribute(t, token_sharding(t, mesh), mesh)
            with torch.no_grad(), S.sharded_region(mesh, rules):
                lg, caches = T.prefill_model(params, cfg, tok(c["prompt"]),
                                             pol, max_len=c["max_len"],
                                             backend=c["backend"])
                logits = [lg.full_tensor().numpy()]
                placements = {k: str(v.placements)
                              for k, v in caches["scan"].items()}
                try:
                    for t in c["steps"]:
                        lg, caches = T.decode_step(
                            params, cfg, tok(t), caches, pol,
                            backend=c["backend"], unroll=c["unroll"])
                        logits.append(lg.full_tensor().numpy())
                except NotImplementedError as e:
                    res[name] = {"refused": str(e),
                                 "placements": placements}
                    continue
            res[name] = {"logits": logits, "placements": placements}
        if rank == 0:
            with open(out / "res.pkl", "wb") as f:
                pickle.dump(res, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        out, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
        torch.multiprocessing.spawn(rank_main, args=(world, port, out),
                                    nprocs=world, join=True)
''')


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    """The 8-rank run of every case, and each case's inputs and
    one-device references (the port's and the JAX package's), computed
    here while the ranks run."""
    out = tmp_path_factory.mktemp("serve_world")
    rng = np.random.default_rng(0)
    cases, inputs = {}, {}
    for name, arch, heads, rules, b, unroll, backend in CASES + REFUSED:
        jcfg, cfg = _configs(arch, heads)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
        npp = jax.tree.map(np.asarray, jp)
        prompt = rng.integers(0, jcfg.vocab_size, (b, PROMPT)).astype(
            np.int32)
        steps = [rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
                 for _ in range(STEPS)]
        cases[name] = {"cfg": cfg, "kw": UNROLL_KW if unroll else KW,
                       "params": npp, "rules": rules, "prompt": prompt,
                       "steps": steps, "unroll": unroll, "backend": backend,
                       "max_len": UNROLL_MAX_LEN if unroll else MAX_LEN}
        inputs[name] = (jcfg, jp, npp, prompt, steps)
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    script = out / "world.py"
    script.write_text(_WORLD)
    world = subprocess.Popen([sys.executable, str(script), str(out), "8",
                              str(_free_port())], env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        refs = {}
        for name, (jcfg, jp, npp, prompt, steps) in inputs.items():
            c = cases[name]
            if name in [r[0] for r in REFUSED]:
                continue
            refs[name] = (
                _one_device(c, npp, prompt, steps),
                None if c["backend"] != "reference" else
                _reference(jcfg, jp, prompt, steps, c))
        _, err = world.communicate(timeout=DEADLINE_S)
    finally:
        world.kill()
    assert world.returncode == 0, err[-4000:]
    with open(out / "res.pkl", "rb") as f:
        return pickle.load(f), refs


def _one_device(c, npp, prompt, steps):
    cfg, backend = c["cfg"], c["backend"]
    tp = params_from_numpy(npp, cfg, device="cpu")
    pol = QuantPolicy(**c["kw"])
    with torch.no_grad():
        lg, caches = T.prefill_model(tp, cfg, torch.from_numpy(prompt), pol,
                                     max_len=c["max_len"], backend=backend)
        out = [lg.numpy()]
        for t in steps:
            lg, caches = T.decode_step(tp, cfg, torch.from_numpy(t), caches,
                                       pol, backend=backend,
                                       unroll=c["unroll"])
            out.append(lg.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _jstep(jcfg, kw: tuple, unroll: bool):
    """The reference's decode step, jitted once a (config, policy, unroll)
    and shared by every step and case (as ``tests/test_torch_families.py``
    jits it); ``kw`` is the policy's sorted items."""
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg,
                                     policy=JPolicy(**dict(kw)),
                                     unroll=unroll))


def _reference(jcfg, jp, prompt, steps, c):
    pol = JPolicy(**c["kw"])
    lg, caches = JT.prefill_model(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                  pol, max_len=c["max_len"])
    out = [np.asarray(lg)]
    step = _jstep(jcfg, tuple(sorted(c["kw"].items())), c["unroll"])
    for t in steps:
        lg, caches = step(jp, token=jnp.asarray(t), caches=caches)
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_serve_matches_one_device_and_reference(serve_world, name):
    res, refs = serve_world
    got = res[name]["logits"]
    port, ref = refs[name]
    assert len(got) == len(port) == STEPS + 1
    for i, (g, p) in enumerate(zip(got, port)):
        np.testing.assert_allclose(g, p, atol=PORT_TOL, rtol=PORT_TOL,
                                   err_msg=f"{name} step {i} vs port")
    if ref is None:         # the cuda backend's plain versions: the JAX
        return              # pairing is test_torch_families' (pallas)
    assert len(ref) == STEPS + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"{name} step {i} vs reference")


def test_context_parallel_decode_on_the_cuda_backend_is_refused(
        serve_world):
    """LONG_SERVE_RULES split the packed tokens over the data ranks; the
    cuda backend has no route for that layout (the reference runs no
    Pallas kernel on a sharded cache either), so its decode step raises,
    unrolled or not, and falls back to nothing."""
    res, _ = serve_world
    for name, *_ in REFUSED:
        assert "attended by the reference backend" in res[name]["refused"]


def test_unrolled_long_context_slice_crosses_a_shard_boundary():
    """Under LONG_SERVE_RULES the 32 packed tokens split 8 a rank over the
    4 data ranks; the unrolled step's local slice ``[st0, st0 + 8)`` lies
    across two ranks' shards in at least one of the steps the world
    runs (the pre-step lengths PROMPT .. PROMPT + STEPS - 1)."""
    from repro_torch.models.attention import slice_indices
    cfg = configs.get_smoke("gemma3_4b")
    pol = QuantPolicy(**UNROLL_KW)
    s_q = UNROLL_MAX_LEN - UNROLL_KW["n_sink"] - UNROLL_KW["window"]
    assert s_q == 4 * N_LOCAL and cfg.local_window == N_LOCAL
    st0 = [int(slice_indices(torch.tensor([t + 1]), pol, cfg.local_window,
                             s_q)[0, 0])
           for t in range(PROMPT, PROMPT + STEPS)]
    crosses = [a // N_LOCAL != (a + cfg.local_window - 1) // N_LOCAL
               for a in st0]
    assert any(crosses), st0


def test_sharded_caches_take_each_rule_tables_layout(serve_world):
    """Under SERVE_RULES the planes split their batch over (pod, data)
    and their kv heads over model; under LONG_SERVE_RULES the packed
    planes split their tokens over (pod, data) and the fp segments stay
    whole; with 3 kv heads over 2 the heads are not split."""
    res, _ = serve_world
    pl = {n: res[n]["placements"] for n in res}
    # stacked (L, B, S, H, W): layout dims (dp, model)
    assert pl["serve"]["qk_codes_hi"] == "(Shard(dim=1), Shard(dim=3))"
    assert pl["long"]["qk_codes_hi"] == "(Shard(dim=2), Shard(dim=3))"
    assert pl["long"]["win_k"] == "(Replicate(), Shard(dim=3))"
    assert pl["repl"]["qk_codes_hi"] == "(Replicate(), Shard(dim=3))"
    assert pl["uneven"]["qk_codes_hi"] == "(Shard(dim=1), Replicate())"


def test_chunked_walk_traces_on_fake_tensors_and_is_exact_on_real(
        monkeypatch):
    """The reference backend's chunked packed walk (``chunk`` 8 over a
    32-token region holding 22 packed tokens: the last tile is dead).
    On real tensors the host skip runs; with the liveness unreadable on
    the host (forced here) every tile is merged and a dead one's merge
    is discarded on the device, bitwise the skip's output and partials;
    on fake tensors (a dry-run's trace) the walk gives the real run's
    shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import attention as TA
    cfg = configs.get_smoke("llama3p2_1b")
    pol = QuantPolicy(**KW)
    params = T.init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT)))
    with torch.no_grad():
        _, caches = T.prefill_model(params, cfg, prompt, pol,
                                    max_len=MAX_LEN, backend="reference")
    cache = {k: v[0] for k, v in caches["scan"].items()}
    assert cache["qk_codes_hi"].shape[1] == 32
    assert int(cache["length"][0]) - KW["n_sink"] - KW["window"] == 22
    q = torch.randn(2, 1, cfg.n_heads, cfg.head_dim,
                    generator=torch.Generator().manual_seed(4))
    walk = lambda q, c: TA.skvq_parts(q, c, cfg, pol, dtype=torch.float32,
                                      chunk=8)
    flat = lambda r: [r[0]] + [t for part in r[1] for t in part]
    real = flat(walk(q, cache))
    monkeypatch.setattr(TA, "_host_readable", lambda t: False)
    selected = flat(walk(q, cache))
    assert all(torch.equal(a, b) for a, b in zip(real, selected))
    monkeypatch.undo()
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fake = flat(walk(fm.from_tensor(q),
                         {k: fm.from_tensor(v) for k, v in cache.items()}))
    assert [(t.shape, t.dtype) for t in fake] == \
        [(t.shape, t.dtype) for t in real]


# one cell of each variant group the fake world once refused: the
# unrolled step under SERVE (decode_32k), LONG (long_500k: the
# context-parallel pre-append) and REPL rules with the chunked walk, the
# chunked walk alone, the sequence-parallel train step, and the fp16
# cache of an enc-dec model (its cross cache's head dim split by the plan)
VARIANT_CELLS = [("gemma3_4b", "decode_32k", "unroll_local"),
                 ("gemma3_4b", "long_500k", "unroll_local"),
                 ("hymba_1p5b", "decode_32k",
                  "replicated+unroll_local+chunked"),
                 ("llama3p2_1b", "decode_32k", "chunked"),
                 ("llama3p2_1b", "train_4k", "seqpar"),
                 ("seamless_m4t_large_v2", "decode_32k", "fp16_cache")]
_CELLS = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.launch import dryrun as D
    torch.set_num_threads(1)
    rows = [D.run_cell(a, s, False, variant=v, smoke=True)
            for a, s, v in json.loads(sys.argv[2])]
    with open(sys.argv[1], "w") as f:
        json.dump(rows, f)
""")


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    """The dry-run CLI on the llama3.2-1b smoke cells and, beside it in
    a second process, :data:`VARIANT_CELLS` through ``run_cell``: (the
    CLI's completed process and rows file, the variant rows)."""
    tmp = tmp_path_factory.mktemp("fake_world")
    out, cells = tmp / "dryrun.json", tmp / "cells.json"
    variants = subprocess.Popen(
        [sys.executable, "-c", _CELLS, str(cells), json.dumps(VARIANT_CELLS)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(tmp))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3p2_1b", "--mesh", "single", "--smoke", "--out", str(out)],
            env=_env(), capture_output=True, text=True, timeout=DEADLINE_S,
            cwd=str(tmp))
        _, err = variants.communicate(timeout=DEADLINE_S)
    finally:
        variants.kill()
    assert variants.returncode == 0, err[-3000:]
    return r, out, json.loads(cells.read_text())


def test_fake_world_dryrun_traces_the_variant_groups(fake_world):
    """Every cell of :data:`VARIANT_CELLS` traces (``status == "ok"``)."""
    _, _, rows = fake_world
    assert [(r["arch"], r["shape"], r["variant"]) for r in rows] == \
        [tuple(c) for c in VARIANT_CELLS]
    for row in rows:
        assert row["status"] == "ok", (row["variant"], row.get("trace"))
        assert row["roofline"]["hbm_bytes"] > 0


def test_fake_world_dryrun_traces_train_prefill_and_decode(fake_world):
    r, out, _ = fake_world
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    rows = {row["shape"]: row for row in json.loads(out.read_text())}
    assert rows["long_500k"]["status"] == "skipped"
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        row = rows[shape]
        assert row["status"] == "ok", row.get("trace")
        assert row["mesh"] == "16x16" and row["smoke"]
        x = row["roofline"]
        assert x["flops"] > 0 and x["hbm_bytes"] > 0
        assert row["memory"]["peak"] >= row["memory"]["argument"] > 0
    # the train step all-gathers its FSDP shards and reduces its grads
    assert {"all-gather", "all-reduce"} <= set(rows["train_4k"]["collectives"]) \
        or {"all-gather", "reduce-scatter"} <= set(
            rows["train_4k"]["collectives"])
    assert "1 ok" not in r.stdout and "3 ok, 1 skipped, 0 errors" in r.stdout
