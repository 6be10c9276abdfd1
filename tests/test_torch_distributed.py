"""The port's distributed substrate on real ranks: eight CPU processes
over gloo, against the JAX reference on eight (or four) forced host
devices in a subprocess, as ``tests/test_distributed.py`` and
``tests/test_pipeline.py`` run it.

One 8-rank world (:func:`world8`, a module fixture, one thread a rank)
runs every multi-rank case and writes what it saw; the reference's
device slices, its ``int8_allreduce_pod`` and its ``pipeline_forward``
come from one subprocess started beside it; its one-device jitted steps
run here.  The cases:

* placement: on (2, 2, 2) ``("pod", "data", "model")`` every rank's
  local shard of every leaf of the llama3.2-1b smoke train state (FSDP)
  equals the slice ``NamedSharding.devices_indices_map`` gives the
  device at the same mesh coordinates.
* train steps on that mesh, from the reference's converted init state:
  llama3.2-1b two steps with remat on (``torch.utils.checkpoint`` over
  DTensors), one with ``grad_compress``, deepseek-moe-16b
  one step (experts over ``model``), each against the port's one-device
  step and (llama) the reference's one-device jitted step.  Tolerances
  are ``tests/test_torch_training.py``'s: loss, nll and grad norm
  ``rtol = 1e-5`` on the first step and ``5e-4`` after; params, the
  AdamW flip count — a weight whose |g| is near eps or zero moves by
  up to 2·lr on a last-bit difference of g (the TP products and the
  gradient all-reduces sum in another order), so weights past ``1e-5``
  (first step; ``1e-4`` after) may be at most 0.1% of all, and none may
  pass 2·lr.
* ``int8_allreduce_pod``: a replicated input, whole or sharded over
  ``model``, bitwise the reference's on its 2-device pod; distinct inputs
  a rank EQUAL to the numpy mean of the
  dequantized codes in gather order; the all-gathers move ``torch.int8``
  codes; no ``pod`` axis returns ``x`` itself.
* ``pipeline_forward`` over the 4-rank ``pod`` groups of a (4, 2) mesh on
  the reference test's case (L 8, B 8, D 16, tanh block), microbatches
  2, 4 and 8: within 1e-6 of the reference's and 1e-5 of the sequential
  run; its gradients (params and input) of ``sum(out * c)`` on every
  rank within 1e-5 of sequential autograd and 1e-6 of ``jax.grad``
  through the reference's, relative to the gradient's largest value.
* one llama3.2-1b step under ``SEQ_PARALLEL_TRAIN_RULES`` against the
  one-device step, at the train tolerances.
* checkpoints: the sharded state saved is byte-equal to a one-device save
  of its values, and loads onto another layout (TP alone) with equal
  values.
* the trainer CLI under ``torchrun`` at world 2 (``--device cpu``).
"""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import DataLoader, SyntheticCorpus
from repro_torch.distributed.compression import int8_allreduce_pod
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.tree import leaves
from repro_torch.training import init_train_state, make_train_step
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LR = 5e-3
BATCH, SEQ = 8, 32
STEP_RTOL, DRIFT_RTOL = 1e-5, 5e-4
PARAM_ATOL = {1: 1e-5, 2: 1e-4}
FLIP_SHARE = 1e-3
MICROBATCHES = (2, 4, 8)
PIPE = dict(L=8, B=8, D=16)
DEADLINE_S = 300                  # the world takes ~25 s alone


def _port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _np(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return t.detach().cpu().numpy()


def _llama():
    """llama3.2-1b smoke with per-block remat, as the trainer runs it."""
    return dataclasses.replace(configs.get_smoke("llama3p2_1b"), remat=True)


def _loader(cfg):
    return DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), batch=BATCH,
                      seq=SEQ, device=CPU)


def _pipe_case():
    rng = np.random.default_rng(0)
    L, B, D = PIPE["L"], PIPE["B"], PIPE["D"]
    w = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return w, b, x


def _pipe_cotangent():
    """The cotangent the pipeline gradients are taken along: the loss is
    ``sum(out * c)``."""
    return np.random.default_rng(1).normal(
        size=(PIPE["B"], PIPE["D"])).astype(np.float32)


def _block(h, p):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipe_grads(run, w, b, x):
    """(dw, db, dx) of ``sum(run(params, x) * c)`` by autograd."""
    pw, pb, px = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    out = run({"w": pw, "b": pb}, px)
    loss = (out * torch.from_numpy(_pipe_cotangent())).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, [pw, pb, px])]


# ----------------------------------------------------------- the 8 ranks

def _rank_main(rank, world, port, out):
    """One rank of the world: every multi-rank case, results under
    ``out`` (rank 0's, plus each rank's local shards)."""
    torch.set_num_threads(1)
    from repro_torch.checkpoint import load_latest
    from repro_torch.distributed import compression
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import (SEQ_PARALLEL_TRAIN_RULES,
                                                  P, distribute,
                                                  to_placements)
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.launch.shardings import named, state_shardings
    from repro_torch.training import place_state
    init_world(CPU, init_method=f"tcp://localhost:{port}",
               world_size=world, rank=rank)
    out = Path(out)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), CPU)
    res = {"coords": [int(c) for c in mesh.get_coordinate()]}
    with open(out / "init.pkl", "rb") as f:
        init = pickle.load(f)

    # placement: this rank's local shards of the smoke state (FSDP)
    cfg = _llama()
    st0 = train_state_from_numpy(init["llama"], cfg, device=CPU)
    st = place_state(st0, mesh)
    np.savez(out / f"shards_{rank}.npz",
             **{k: v.to_local().numpy() for k, v in _flat(st).items()})

    # llama3.2-1b: two sharded steps
    step = make_train_step(cfg, lr_fn=lambda s: LR, mesh=mesh)
    dl = _loader(cfg)
    res["llama"] = []
    for i in range(2):
        st, m = step(st, dl.batch_at(i))
        res["llama"].append(({k: float(v) for k, v in m.items()},
                             _np(st["params"])))
    # the sharded state saved (rank 0 writes), then loaded onto TP alone
    save_checkpoint(str(out / "ck_sharded"), 2, st)
    res["saved"] = _np(st)
    tp = named(state_shardings(st0, mesh, fsdp=False), mesh)
    back = load_latest(str(out / "ck_sharded"), st0, device=CPU,
                       shardings=tp)["state"]
    ok = True
    for (k, a), b, sh in zip(_flat(back).items(), leaves(st),
                             leaves(tp)):
        ok &= tuple(a.placements) == tuple(to_placements(sh.spec, mesh))
        ok &= torch.equal(a.full_tensor(), b.full_tensor())
    res["reload_ok"] = ok

    # one step with gradient compression
    stc = place_state(train_state_from_numpy(init["llama_ef"], cfg,
                                             device=CPU), mesh)
    stepc = make_train_step(cfg, lr_fn=lambda s: LR, grad_compress=True,
                            mesh=mesh)
    stc, m = stepc(stc, dl.batch_at(0))
    res["compress"] = ({k: float(v) for k, v in m.items()},
                       _np(stc["params"]), _np(stc["ef"]))

    # deepseek-moe-16b: one sharded step, experts over model
    mcfg = configs.get_smoke("deepseek_moe_16b")
    stm = place_state(init_train_state(mcfg, seed=0, device=CPU), mesh)
    res["moe_experts_placement"] = str(
        stm["params"]["layers"]["moe"]["experts_up"].placements)
    stepm = make_train_step(mcfg, lr_fn=lambda s: LR, mesh=mesh)
    stm, m = stepm(stm, _loader(mcfg).batch_at(0))
    res["moe"] = ({k: float(v) for k, v in m.items()}, _np(stm["params"]))

    # llama3.2-1b: one sequence-parallel step (the sequence over model)
    sts = place_state(train_state_from_numpy(init["llama"], cfg, device=CPU),
                      mesh)
    steps = make_train_step(cfg, lr_fn=lambda s: LR, mesh=mesh,
                            rules=SEQ_PARALLEL_TRAIN_RULES)
    sts, m = steps(sts, dl.batch_at(0))
    res["seqpar"] = ({k: float(v) for k, v in m.items()},
                     _np(sts["params"]))

    # int8 wire: replicated input, then distinct inputs a rank
    dtypes = []
    gather = compression.dist.all_gather_into_tensor

    def spy(t, *a, **kw):
        dtypes.append(str(t.dtype))
        return gather(t, *a, **kw)
    compression.dist.all_gather_into_tensor = spy
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(16, 33)).astype(np.float32))
    res["int8_replicated"] = int8_allreduce_pod(x, mesh).numpy()
    xd = int8_allreduce_pod(distribute(x, P("model"), mesh), mesh)
    res["int8_dtensor"] = (str(xd.placements), xd.full_tensor().numpy())
    xr = torch.from_numpy(np.random.default_rng(100 + rank).normal(
        size=(16, 33)).astype(np.float32) * (1 + rank))
    res["int8_distinct"] = int8_allreduce_pod(xr, mesh).numpy()
    compression.dist.all_gather_into_tensor = gather
    res["int8_dtypes"] = dtypes

    # GPipe over the 4-rank pod groups of a (4, 2) mesh
    pmesh = make_mesh((4, 2), ("pod", "model"), CPU)
    w, b, xp = _pipe_case()
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    res["pipe"] = {mb: pipeline_forward(_block, params, torch.from_numpy(xp),
                                        mesh=pmesh, microbatches=mb).numpy()
                   for mb in MICROBATCHES}
    grads = {}
    for mb in MICROBATCHES:
        run = lambda p, v: pipeline_forward(_block, p, v, mesh=pmesh,
                                            microbatches=mb)
        grads.update({f"{mb}_{n}": g for n, g in
                      zip("wbx", _pipe_grads(run, w, b, xp))})
    np.savez(out / f"pipe_grad_{rank}.npz", **grads)
    if rank == 0:
        with open(out / "res.pkl", "wb") as f:
            pickle.dump(res, f)
    with open(out / f"rank_{rank}.json", "w") as f:
        json.dump({"coords": res["coords"], "reload_ok": bool(ok),
                   "int8_distinct": res["int8_distinct"].tolist(),
                   "int8_dtypes": dtypes,
                   "pipe": {k: v.tolist() for k, v in res["pipe"].items()}},
                  f)
    dist.destroy_process_group()


_REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import configs
    from repro.training import init_train_state
    from repro.launch.shardings import state_shardings
    from repro.launch.mesh import make_mesh
    from repro.distributed.compression import int8_allreduce_pod
    from repro.distributed.pipeline import pipeline_forward

    out, case = sys.argv[1], pickle.load(open(sys.argv[2], "rb"))
    res = {}
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = jax.eval_shape(lambda: init_train_state(
        configs.get_smoke("llama3p2_1b"), jax.random.PRNGKey(0)))
    sh = state_shardings(shape, mesh, fsdp=True)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(shape)[0])
    slices = {}
    for path, s in flat:
        name = "/".join(str(p.key) for p in path)
        dims = shapes[path].shape
        m = s.devices_indices_map(dims)
        per = {}
        for idx in np.ndindex(mesh.devices.shape):
            sl = m[mesh.devices[idx]]
            per[idx] = [(q.start or 0, dims[i] if q.stop is None else q.stop)
                        for i, q in enumerate(sl)]
        slices[name] = per
    res["slices"] = slices
    x = jnp.asarray(case["int8_x"])
    res["int8"] = np.asarray(jax.jit(lambda v: int8_allreduce_pod(v, mesh))(x))
    w, b, xp = case["pipe"]
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    block = lambda h, p: jnp.tanh(h @ p["w"] + p["b"])
    seq = jnp.asarray(xp)
    for i in range(w.shape[0]):
        seq = block(seq, {"w": params["w"][i], "b": params["b"][i]})
    res["pipe_seq"] = np.asarray(seq)
    pmesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
    res["pipe"], res["pipe_grad"] = {}, {}
    cot = jnp.asarray(case["pipe_cot"])
    for mb in case["microbatches"]:
        with pmesh:
            res["pipe"][mb] = np.asarray(jax.jit(lambda v: pipeline_forward(
                block, params, v, mesh=pmesh, axis="pod",
                microbatches=mb))(jnp.asarray(xp)))
            loss = lambda p, v: jnp.sum(pipeline_forward(
                block, p, v, mesh=pmesh, axis="pod", microbatches=mb) * cot)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                params, jnp.asarray(xp))
        res["pipe_grad"][mb] = [np.asarray(gp["w"]), np.asarray(gp["b"]),
                                np.asarray(gx)]
    pickle.dump(res, open(os.path.join(out, "reference.pkl"), "wb"))
""")


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """Runs the 8-rank world and the reference's multi-device subprocess
    side by side; returns (rank 0's results, the reference's, the
    directory with every rank's files, the reference's init states)."""
    import jax
    from repro import configs as jconfigs
    from repro.training import init_train_state as j_init_state
    out = tmp_path_factory.mktemp("world8")
    jcfg = jconfigs.get_smoke("llama3p2_1b")
    init = {"llama": jax.tree.map(np.asarray, j_init_state(
                jcfg, jax.random.PRNGKey(0))),
            "llama_ef": jax.tree.map(np.asarray, j_init_state(
                jcfg, jax.random.PRNGKey(0), grad_compress=True))}
    with open(out / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    case = {"int8_x": np.random.default_rng(7).normal(size=(16, 33)).astype(
                np.float32),
            "pipe": _pipe_case(), "pipe_cot": _pipe_cotangent(),
            "microbatches": MICROBATCHES}
    with open(out / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out),
                            str(out / "case.pkl")], env=env, cwd=str(ROOT),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(8, _port(), str(out)), nprocs=8, join=False,
        start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1):      # raises if a rank fails
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            ref.kill()
            pytest.fail(f"the 8-rank world ran past {DEADLINE_S} s")
    _, err = ref.communicate(timeout=DEADLINE_S)
    assert ref.returncode == 0, err[-3000:]
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    return res, reference, out, init


def _check_params(got, want, n_step, what):
    """The AdamW flip count of test_torch_training: weights past
    PARAM_ATOL at most FLIP_SHARE of all, none past 2·lr."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    flips = total = 0
    for k in want:
        d = np.abs(np.asarray(got[k], np.float64) - want[k])
        flips += int((d > PARAM_ATOL[n_step]).sum())
        total += d.size
        assert d.max() <= 2 * LR, (what, k, d.max())
    assert flips <= FLIP_SHARE * total, (what, flips, total)


def _check_metrics(got, want, n_step, what):
    for k in ("loss", "nll", "grad_norm"):
        assert got[k] == pytest.approx(
            want[k], rel=STEP_RTOL if n_step == 1 else DRIFT_RTOL), (what, k)


def _port_steps(cfg, state, n, **kw):
    step = make_train_step(cfg, lr_fn=lambda s: LR, **kw)
    dl, out = _loader(cfg), []
    for i in range(n):
        state, m = step(state, dl.batch_at(i))
        out.append(({k: float(v) for k, v in m.items()}, state))
    return out


def test_local_shards_equal_the_reference_device_slices(world8):
    _, ref, out, init = world8
    cfg = configs.get_smoke("llama3p2_1b")
    full = _flat(_np(train_state_from_numpy(init["llama"], cfg, device=CPU)))
    assert sorted(full) == sorted(ref["slices"])
    for rank in range(8):
        with open(out / f"rank_{rank}.json") as f:
            coords = tuple(json.load(f)["coords"])
        # rank r sits at the row-major coordinates of r, as JAX's devices
        assert coords == tuple(int(c) for c in np.unravel_index(rank,
                                                                (2, 2, 2)))
        shards = np.load(out / f"shards_{rank}.npz")
        for k, v in full.items():
            sl = tuple(slice(a, b) for a, b in ref["slices"][k][coords])
            np.testing.assert_array_equal(shards[k], v[sl], err_msg=k)


def test_sharded_llama_steps_match_one_device_and_reference(world8):
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.data import DataLoader as JLoader
    from repro.data import SyntheticCorpus as JCorpus
    from repro.training import make_train_step as j_make_step
    res, _, _, init = world8
    cfg = _llama()
    ours = _port_steps(cfg, train_state_from_numpy(init["llama"], cfg,
                                                   device=CPU), 2)
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3p2_1b"), remat=True)
    jstep = jax.jit(j_make_step(jcfg, lr_fn=lambda s: jnp.float32(LR)))
    jst = jax.tree.map(jnp.asarray, init["llama"])
    jdl = JLoader(JCorpus(jcfg.vocab_size, seed=1), batch=BATCH, seq=SEQ)
    for i in range(2):
        jst, jm = jstep(jst, jdl.batch_at(i))
        got_m, got_p = res["llama"][i]
        _check_metrics(got_m, ours[i][0], i + 1, f"port step {i + 1}")
        _check_params(got_p, _np(ours[i][1]["params"]), i + 1,
                      f"port step {i + 1}")
        _check_metrics(got_m, {k: float(v) for k, v in jm.items()}, i + 1,
                       f"reference step {i + 1}")
        _check_params(got_p, jax.tree.map(np.asarray, jst["params"]), i + 1,
                      f"reference step {i + 1}")


def test_sharded_step_with_grad_compress(world8):
    res, _, _, init = world8
    cfg = _llama()
    (m, st), = _port_steps(cfg, train_state_from_numpy(
        init["llama_ef"], cfg, device=CPU), 1, grad_compress=True)
    got_m, got_p, got_ef = res["compress"]
    _check_metrics(got_m, m, 1, "grad_compress")
    _check_params(got_p, _np(st["params"]), 1, "grad_compress")
    # the residuals are g - dequant(q(g)): below half a code step a leaf
    for k, e in _flat(got_ef).items():
        assert np.isfinite(e).all(), k


def test_sharded_moe_step_with_experts_over_model(world8):
    res, _, _, _ = world8
    cfg = configs.get_smoke("deepseek_moe_16b")
    assert res["moe_experts_placement"].count("Shard(dim=1)") == 1
    (m, st), = _port_steps(cfg, init_train_state(cfg, seed=0, device=CPU), 1)
    got_m, got_p = res["moe"]
    _check_metrics(got_m, m, 1, "deepseek")
    _check_params(got_p, _np(st["params"]), 1, "deepseek")


def _numpy_int8_mean(xs):
    """The wire's arithmetic in numpy: per-tensor scale max|x| / 127 (f32,
    floor 1e-20), codes round-half-even clipped to ±127, dequantized and
    summed in f32 in gather order, divided by the count."""
    acc = None
    for x in xs:
        scale = np.maximum(np.abs(x).max() / np.float32(127.0),
                           np.float32(1e-20)).astype(np.float32)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        d = q.astype(np.float32) * scale
        acc = d if acc is None else (acc + d).astype(np.float32)
    return (acc / np.float32(len(xs))).astype(np.float32)


def test_int8_allreduce_pod_equals_the_reference_and_numpy(world8):
    res, ref, out, _ = world8
    np.testing.assert_array_equal(res["int8_replicated"], ref["int8"])
    # sharded over model: each member's scale over its whole tensor
    placements, full = res["int8_dtensor"]
    assert placements == "(Replicate(), Shard(dim=0))", placements
    np.testing.assert_array_equal(full, ref["int8"])
    for rank in range(8):
        with open(out / f"rank_{rank}.json") as f:
            r = json.load(f)
        # the gathers: codes then scales, per call (three calls)
        assert r["int8_dtypes"] == ["torch.int8", "torch.float32"] * 3
        members = [rank % 4, rank % 4 + 4]        # the pod group, in order
        xs = [(np.random.default_rng(100 + m).normal(size=(16, 33)).astype(
            np.float32) * np.float32(1 + m)).astype(np.float32)
            for m in members]
        np.testing.assert_array_equal(
            np.asarray(r["int8_distinct"], np.float32), _numpy_int8_mean(xs))


def test_int8_allreduce_pod_without_a_pod_axis_returns_x():
    x = torch.randn(4, 5)
    for mesh in (AbstractMesh((2, 2), ("data", "model")),
                 AbstractMesh((1, 2, 2), ("pod", "data", "model"))):
        assert int8_allreduce_pod(x, mesh) is x


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_pipeline_forward_matches_reference_and_sequential(world8,
                                                           microbatches):
    _, ref, out, _ = world8
    w, b, xp = _pipe_case()
    h = torch.from_numpy(xp)
    for i in range(PIPE["L"]):
        h = _block(h, {"w": torch.from_numpy(w[i]), "b": torch.from_numpy(b[i])})
    for rank in range(8):
        with open(out / f"rank_{rank}.json") as f:
            got = np.asarray(json.load(f)["pipe"][str(microbatches)],
                             np.float32)
        assert np.abs(got - ref["pipe"][microbatches]).max() <= 1e-6
        assert np.abs(got - h.numpy()).max() <= 1e-5
        assert np.abs(got - ref["pipe_seq"]).max() <= 1e-5


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_pipeline_gradients_match_reference_and_sequential(world8,
                                                           microbatches):
    """Every rank's gradients of ``sum(pipeline_forward(...) * c)`` in the
    params and the input: within 1e-5 of sequential autograd and 1e-6 of
    ``jax.grad`` through the reference's ``pipeline_forward``, both
    relative to the gradient's largest magnitude (the weight gradients
    reach ~3.3, where an f32 ulp is 2.4e-7, and torch and XLA sum the
    backward products in other orders; the forward test's values are
    tanh outputs, below 1)."""
    _, ref, out, _ = world8
    w, b, xp = _pipe_case()

    def sequential(p, h):
        for i in range(PIPE["L"]):
            h = _block(h, {"w": p["w"][i], "b": p["b"][i]})
        return h
    seq = _pipe_grads(sequential, w, b, xp)
    for rank in range(8):
        got = np.load(out / f"pipe_grad_{rank}.npz")
        for n, s_, r in zip("wbx", seq, ref["pipe_grad"][microbatches]):
            g = got[f"{microbatches}_{n}"]
            scale = np.abs(s_).max()
            assert np.abs(g - s_).max() <= 1e-5 * scale, (rank, n)
            assert np.abs(g - r).max() <= 1e-6 * scale, (rank, n)


def test_sequence_parallel_step_matches_one_device(world8):
    """One llama3.2-1b step under ``SEQ_PARALLEL_TRAIN_RULES`` (the
    sequence over ``model`` between the products) equals the one-device
    port's step, within the train tolerances."""
    res, _, _, init = world8
    cfg = _llama()
    (m, st), = _port_steps(cfg, train_state_from_numpy(init["llama"], cfg,
                                                       device=CPU), 1)
    got_m, got_p = res["seqpar"]
    _check_metrics(got_m, m, 1, "seqpar")
    _check_params(got_p, _np(st["params"]), 1, "seqpar")


def test_sharded_checkpoint_is_a_one_device_save_and_reshards(world8,
                                                              tmp_path):
    res, _, out, _ = world8
    assert all(json.load(open(out / f"rank_{r}.json"))["reload_ok"]
               for r in range(8))
    one = save_checkpoint(str(tmp_path), 2, _tensors(res["saved"]))
    sharded = out / "ck_sharded" / "step_00000002"
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(sharded))
    for n in names:
        assert (Path(one) / n).read_bytes() == (sharded / n).read_bytes(), n


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_trainer_cli_under_torchrun_matches_one_process(tmp_path, capsys):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train`` on the
    CPU: rank 0's step lines equal the one-process CLI's (loss and grad
    norm within DRIFT_RTOL, lr equal, ms masked), rank 1 prints nothing,
    and the checkpoints are rank 0's one save a step."""
    import re
    from repro_torch.launch import train as ttrain
    argv = ["--smoke", "--device", CPU, "--steps", "3", "--log-every", "1",
            "--save-every", "2"]
    logs = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", str(logs), "--redirects", "3",
         "-m", "repro_torch.launch.train", *argv,
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    outs = {p.parent.name: p.read_text() for p in logs.rglob("stdout.log")}
    assert sorted(outs) == ["0", "1"] and outs["1"] == ""
    ttrain.main(argv)
    want = capsys.readouterr().out.splitlines()
    got = outs["0"].splitlines()
    assert len(got) == len(want) == 4
    num = re.compile(r"step +(\d+) loss ([\d.]+) lr (\S+) gnorm ([\d.]+) \d+ms")
    for g, w in zip(got[:3], want[:3]):
        (gs, gl, glr, gn), (ws, wl, wlr, wn) = num.match(g).groups(), \
            num.match(w).groups()
        assert (gs, glr) == (ws, wlr)
        assert float(gl) == pytest.approx(float(wl), rel=DRIFT_RTOL, abs=1e-4)
        assert float(gn) == pytest.approx(float(wn), rel=DRIFT_RTOL, abs=1e-2)
    assert got[3] == want[3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000000", "step_00000002"]
