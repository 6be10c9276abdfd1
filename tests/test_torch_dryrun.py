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
  the head split).  The logits of every step are held to the one-device
  port's and to the reference's ``prefill_model`` / ``decode_step`` from
  the same params and tokens.
  Tolerances: the one-device port's within ``atol = rtol = 1e-5`` (the
  same f32 math; the tensor-parallel products sum their halves in
  another order); the reference's within ``test_torch_model.py``'s 2e-4
  (torch and XLA sum matmuls in different orders).
* A fake world (``launch.dryrun``: 256 fake ranks, 16 x 16) traces one
  cell each of train, prefill and decode of the llama3.2-1b smoke config
  at the cells' shapes: rows with ``status == "ok"``, the long_500k cell
  skipped as ``SKIPS`` says, exit 0.
"""
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

ROOT = Path(__file__).resolve().parents[1]
KW = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=4)
PROMPT, MAX_LEN, STEPS = 34, 44, 4      # packed region 32 = 4 ranks x 8
PORT_TOL, REF_TOL = 1e-5, 2e-4
# (case, arch, heads override, rules, batch)
CASES = [("serve", "llama3p2_1b", None, "SERVE_RULES", 4),
         ("repl", "llama3p2_1b", None, "REPL_SERVE_RULES", 1),
         ("long", "llama3p2_1b", None, "LONG_SERVE_RULES", 1),
         ("uneven", "llama3p2_1b", (6, 3), "SERVE_RULES", 4)]
DEADLINE_S = 600


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _configs(heads):
    jcfg, cfg = jconfigs.get_smoke("llama3p2_1b"), configs.get_smoke(
        "llama3p2_1b")
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
                                             backend="reference")
                logits = [lg.full_tensor().numpy()]
                placements = {k: str(v.placements)
                              for k, v in caches["scan"].items()}
                for t in c["steps"]:
                    lg, caches = T.decode_step(params, cfg, tok(t), caches,
                                               pol, backend="reference")
                    logits.append(lg.full_tensor().numpy())
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
    one-device references (the port's and the JAX package's)."""
    out = tmp_path_factory.mktemp("serve_world")
    rng = np.random.default_rng(0)
    cases, refs = {}, {}
    for name, arch, heads, rules, b in CASES:
        jcfg, cfg = _configs(heads)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
        npp = jax.tree.map(np.asarray, jp)
        prompt = rng.integers(0, jcfg.vocab_size, (b, PROMPT)).astype(
            np.int32)
        steps = [rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
                 for _ in range(STEPS)]
        cases[name] = {"cfg": cfg, "kw": KW, "params": npp,
                       "rules": rules, "prompt": prompt, "steps": steps,
                       "max_len": MAX_LEN}
        refs[name] = (_one_device(cfg, npp, prompt, steps),
                      _reference(jcfg, jp, prompt, steps))
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    script = out / "world.py"
    script.write_text(_WORLD)
    r = subprocess.run([sys.executable, str(script), str(out), "8",
                        str(_free_port())], env=_env(), capture_output=True,
                       text=True, timeout=DEADLINE_S)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out / "res.pkl", "rb") as f:
        return pickle.load(f), refs


def _one_device(cfg, npp, prompt, steps):
    tp = params_from_numpy(npp, cfg, device="cpu")
    pol = QuantPolicy(**KW)
    with torch.no_grad():
        lg, caches = T.prefill_model(tp, cfg, torch.from_numpy(prompt), pol,
                                     max_len=MAX_LEN, backend="reference")
        out = [lg.numpy()]
        for t in steps:
            lg, caches = T.decode_step(tp, cfg, torch.from_numpy(t), caches,
                                       pol, backend="reference")
            out.append(lg.numpy())
    return out


def _reference(jcfg, jp, prompt, steps):
    pol = JPolicy(**KW)
    lg, caches = JT.prefill_model(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                  pol, max_len=MAX_LEN)
    out = [np.asarray(lg)]
    for t in steps:
        lg, caches = JT.decode_step(jp, jcfg, jnp.asarray(t), caches, pol)
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_serve_matches_one_device_and_reference(serve_world, name):
    res, refs = serve_world
    got = res[name]["logits"]
    port, ref = refs[name]
    assert len(got) == len(port) == len(ref) == STEPS + 1
    for i, (g, p, r) in enumerate(zip(got, port, ref)):
        np.testing.assert_allclose(g, p, atol=PORT_TOL, rtol=PORT_TOL,
                                   err_msg=f"{name} step {i} vs port")
        np.testing.assert_allclose(g, r, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"{name} step {i} vs reference")


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


def test_fake_world_dryrun_traces_train_prefill_and_decode(tmp_path):
    out = tmp_path / "dryrun.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3p2_1b", "--mesh", "single", "--smoke", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=DEADLINE_S,
        cwd=str(tmp_path))
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
