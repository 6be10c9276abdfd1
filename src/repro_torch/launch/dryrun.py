"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake ranks
(port of ``repro.launch.dryrun``).

The proof that the distribution config is coherent without the hardware:
one process joins a ``"fake"`` process group (``torch.testing._internal.
distributed.fake_pg``: collectives return at once and move nothing) of
256 ranks (``--mesh single``, 16 x 16) or 512 (``multi``, 2 x 16 x 16)
as rank 0; the production mesh and its layout are built first, then
under ``FakeTensorMode`` (shapes and dtypes, no storage) the params,
train state, caches and tokens are fake DTensors laid out by the plans of
``launch.shardings``, and one train step, prefill or decode step runs on
them through the reference backend (no kernel launches, as the
reference's CPU dry-run runs no Pallas).  Every cell must trace:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3p2_1b --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

What a row holds:

  * ``roofline``: FLOPs and bytes from ``op_cost`` over the traced step
    (GLOBAL, divided by the device count, as the reference does), wire
    bytes from ``roofline.CollectiveCounter`` (per device: rank 0's
    collectives), ``model_flops`` per device, the terms on the H100
    constants of ``launch.roofline``;
  * ``collectives``: wire bytes and counts by kind;
  * ``memory`` (per device, from ``torch.distributed._tools.mem_tracker.
    MemTracker`` on rank 0's fake shards): ``argument`` the bytes of the
    step's inputs (params or train state, caches, tokens or batch),
    ``output`` those of its outputs, ``alias`` the outputs that are
    inputs written in place (a decode step's caches), ``peak`` the most
    the tracker saw live during the step, the arguments included, and
    ``temp`` = ``peak - argument``, what the step needs beyond its
    inputs;
  * ``compile_s``: the seconds the cell took to trace (the reference's
    lower + compile seconds).

The reference's ``xla_cost`` (XLA's own ``cost_analysis``, kept there to
show it undercounts scanned layers) is dropped: there is no compiler here,
and the port's layers are a Python loop that ``op_cost`` counts exactly.
A cell that raises is recorded as ``status="error"`` with its trace, and
the run exits 1; nothing is skipped that ``configs.shapes.SKIPS`` does
not skip.  Results append to ``--out`` (a JSON list, git-ignored under
``experiments/``) after each cell, so an interrupted sweep resumes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

import torch

from .. import configs
from ..configs import shapes as shp
from ..core.policy import FP16_POLICY, PAPER_POLICY, QuantPolicy
from ..distributed import sharding as S
from ..models import transformer as T
from ..training import make_train_step
from ..tree import leaves, tree_map
from . import op_cost as OC
from . import roofline as RL
from .shardings import (batch_shardings, cache_shardings, params_shardings,
                        place, state_shardings, token_sharding)

COMPUTE_DTYPE = torch.bfloat16

# §Perf variants — configuration overlays measured against "base".
# "base" pins the paper-faithful/naive settings; each named variant flips one
# lever so the roofline delta is attributable.
VARIANTS = {
    "base": {},
    # training levers
    "remat_full": {"remat_policy": "nothing"},
    "moe_grouped": {"moe_dispatch": "grouped"},
    "seqpar": {"seq_parallel": True},
    "remat_full+moe_grouped": {"remat_policy": "nothing",
                               "moe_dispatch": "grouped"},
    # decode levers
    "fp16_cache": {"policy": "fp16"},        # the paper's own before/after
    "chunked": {"chunk": 4096},
    "unroll_local": {"unroll": True},
    "unroll_local+chunked": {"unroll": True, "chunk": 4096},
    # batch=1 long context: SKVQ's 8× compression makes full replication of
    # the packed cache viable — no context-parallel collectives at all
    "replicated": {"replicate_cache": True},
    "replicated+unroll_local": {"replicate_cache": True, "unroll": True},
    "replicated+unroll_local+chunked": {"replicate_cache": True,
                                        "unroll": True, "chunk": 4096},
}
_BASE_TRAIN = {"remat_policy": "dots", "moe_dispatch": "scatter"}

_MESHES: Dict[bool, object] = {}


def fake_world(n: int) -> None:
    """Rank 0 of a ``"fake"`` process group of ``n`` ranks (the one of
    another size, if any, is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake world of its size, its layout mesh
    built too (both before ``FakeTensorMode`` is entered: a mesh holds a
    real rank tensor)."""
    from .mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    if multi_pod not in _MESHES:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        S.layout_mesh(mesh)
        _MESHES[multi_pod] = mesh
    return _MESHES[multi_pod]


def _fake(spec_tree):
    """Fake tensors (empty, inside the fake mode) of a tree of specs."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), spec_tree)


def _local(x):
    return x._local_tensor if S.is_dtensor(x) else x


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [y for t in tree for y in _flat(t)]
    if isinstance(tree, dict):
        return leaves(tree)
    return [tree] if isinstance(tree, torch.Tensor) else []


def _trace(fn, args) -> Dict:
    """Run ``fn(*args)`` (inside the fake mode) under the memory tracker,
    the collective counter and the op counter: costs, collectives and the
    memory rows."""
    from torch.distributed._tools.mem_tracker import MemTracker
    arg_locals = [_local(x) for x in _flat(args)]
    mt = MemTracker()
    mt.track_external(*arg_locals)
    cc = RL.CollectiveCounter()
    with mt, cc, OC.OpCounter() as oc:
        out = fn(*args)
    peak = sum(v.get("Total", 0)
               for v in mt.get_tracker_snapshot("peak").values())
    arg_b = sum(t.numel() * t.element_size() for t in arg_locals)
    storages = {t.untyped_storage()._cdata for t in arg_locals}
    out_locals = [_local(x) for x in _flat(out)]
    out_b = sum(t.numel() * t.element_size() for t in out_locals)
    alias = sum(t.numel() * t.element_size() for t in out_locals
                if t.untyped_storage()._cdata in storages)
    peak = max(peak, arg_b)
    return {"costs": oc.totals(), "by_category": oc.counts,
            "collectives": RL.collective_stats(cc),
            "memory": {"argument": arg_b, "output": out_b,
                       "temp": peak - arg_b, "peak": peak, "alias": alias}}


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def lower_train(cfg, shape: str, mesh, seq_parallel=False) -> Dict:
    cfg = dataclasses.replace(cfg, remat=True)
    rules = dict(S.TRAIN_RULES)
    if seq_parallel:
        rules["seq"] = "model"
    with _fake_mode():
        params = shp.fake_params(cfg, torch.float32)
        state = {"params": params,
                 "opt": {"m": tree_map(torch.zeros_like, params),
                         "v": tree_map(torch.zeros_like, params),
                         "step": torch.zeros((), dtype=torch.int32)},
                 "step": torch.zeros((), dtype=torch.int32)}
        state = place(state, state_shardings(state, mesh, fsdp=True), mesh)
        batch = _fake(shp.train_input_specs(cfg, shape, COMPUTE_DTYPE))
        batch = place(batch, batch_shardings(batch, mesh), mesh)
        step = make_train_step(cfg, compute_dtype=COMPUTE_DTYPE, mesh=mesh,
                               rules=rules)
        return _trace(step, (state, batch))


def _fake_params(cfg, mesh):
    params = shp.fake_params(cfg, COMPUTE_DTYPE)
    return place(params, params_shardings(params, mesh), mesh)


def lower_prefill(cfg, shape: str, mesh, policy: QuantPolicy) -> Dict:
    ml = shp.serve_max_len(shp.SHAPES[shape]["seq_len"], policy)
    with _fake_mode(), torch.no_grad():
        params = _fake_params(cfg, mesh)
        batch = _fake(shp.prefill_input_specs(cfg, shape, COMPUTE_DTYPE))
        batch = place(batch, batch_shardings(batch, mesh), mesh)

        def prefill(params, batch):
            with S.sharded_region(mesh, S.SERVE_RULES):
                return T.prefill_model(
                    params, cfg, batch.get("tokens"), policy, max_len=ml,
                    dtype=COMPUTE_DTYPE, backend="reference",
                    embeds=batch.get("embeds"),
                    positions=batch.get("positions"),
                    enc_embeds=batch.get("enc_embeds"))
        return _trace(prefill, (params, batch))


def lower_decode(cfg, shape: str, mesh, policy: QuantPolicy, chunk=0,
                 unroll=False, replicate_cache=False) -> Dict:
    long_ctx = (shp.SHAPES[shape]["global_batch"] == 1
                and not replicate_cache)
    caches_spec = shp.decode_cache_specs(cfg, shape, policy,
                                         dtype=COMPUTE_DTYPE)
    if long_ctx:
        rules = S.LONG_SERVE_RULES
    elif replicate_cache:
        rules = S.REPL_SERVE_RULES
    else:
        rules = S.SERVE_RULES
    with _fake_mode(), torch.no_grad():
        params = _fake_params(cfg, mesh)
        caches = _fake(caches_spec)
        caches = place(caches, cache_shardings(caches, cfg, mesh,
                                               long_ctx=long_ctx), mesh)
        tok = _fake(shp.decode_token_spec(cfg, shape, COMPUTE_DTYPE))
        tok = place(tok, token_sharding(tok, mesh), mesh)
        emb = cfg.input_embeds

        def decode(params, token, caches):
            with S.sharded_region(mesh, rules):
                return T.decode_step(
                    params, cfg, None if emb else token, caches, policy,
                    dtype=COMPUTE_DTYPE, backend="reference", chunk=chunk,
                    unroll=unroll, embeds=token if emb else None)
        return _trace(decode, (params, tok, caches))


def run_cell(arch: str, shape: str, multi_pod: bool,
             policy: QuantPolicy = PAPER_POLICY,
             variant: str = "base", smoke: bool = False) -> Dict:
    """One cell's row; ``smoke`` traces the arch's smoke config (narrow,
    few layers) at the cell's shapes, a quick check of the path."""
    res: Dict = {"arch": arch, "shape": shape, "variant": variant,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if smoke:
        res["smoke"] = True
    skip = shp.cell_is_skipped(arch, shape)
    if skip:
        res.update(status="skipped", reason=skip)
        return res
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    kind = shp.SHAPES[shape]["kind"]
    n_dev = 512 if multi_pod else 256
    ov = dict(VARIANTS[variant])
    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        if kind == "train":
            cfg = dataclasses.replace(
                cfg,
                remat_policy=ov.get("remat_policy",
                                    _BASE_TRAIN["remat_policy"]),
                moe_dispatch=ov.get("moe_dispatch",
                                    _BASE_TRAIN["moe_dispatch"]))
            tr = lower_train(cfg, shape, mesh,
                             seq_parallel=ov.get("seq_parallel", False))
        elif kind == "prefill":
            tr = lower_prefill(cfg, shape, mesh, policy)
        else:
            pol = FP16_POLICY if ov.get("policy") == "fp16" else policy
            tr = lower_decode(
                cfg, shape, mesh, pol, chunk=ov.get("chunk", 0),
                unroll=ov.get("unroll", False),
                replicate_cache=ov.get("replicate_cache", False))
        mf = RL.model_flops(cfg, kind, shp.SHAPES[shape]["global_batch"],
                            shp.SHAPES[shape]["seq_len"]) / n_dev
        rl = RL.from_counts(tr["costs"], tr["collectives"]["wire_bytes"],
                            tr["memory"]["peak"], mf, n_devices=n_dev)
        res.update(status="ok", compile_s=round(time.time() - t0, 1),
                   roofline=rl.to_dict(), memory=tr["memory"],
                   collectives=tr["collectives"]["by_kind"],
                   op_cost={k: dict(v) for k, v in
                            tr["by_category"].items()})
    except Exception as e:  # a failing cell is a bug — record it loudly
        res.update(status="error", compile_s=round(time.time() - t0, 1),
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return res


def _fmt_cell(res: Dict) -> str:
    v = res.get("variant", "base")
    head = f"{res['arch']:22s} {res['shape']:11s} {res['mesh']:7s} {v:12s}"
    if res["status"] == "skipped":
        return f"{head} SKIP ({res['reason'][:40]})"
    if res["status"] == "error":
        return f"{head} ERROR {res['error'][:80]}"
    r, m = res["roofline"], res["memory"]
    return (f"{head} ok tC={r['t_compute']:.3e} tM={r['t_memory']:.3e} "
            f"tX={r['t_collective']:.3e} dom={r['dominant']:10s} "
            f"temp={m['temp']/2**30:.1f}GiB comp={res['compile_s']:.0f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="trace each arch's smoke config (a quick check)")
    args = ap.parse_args(argv)

    archs = [a for a in configs.ARCHS if a != "llama2_7b"] \
        if (args.all or not args.arch) else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done: Dict[str, Dict] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            done = {(f"{r['arch']}|{r['shape']}|{r['mesh']}"
                     f"|{r.get('variant', 'base')}"): r
                    for r in json.load(f)}

    torch.set_num_threads(1)
    # one fake world a mesh: the 512-rank one replaces the 256-rank one
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                key = (f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                       f"|{args.variant}")
                if key in done and done[key]["status"] != "error":
                    print(_fmt_cell(done[key]), "(cached)")
                    continue
                res = run_cell(arch, shape, mp, variant=args.variant,
                               smoke=args.smoke)
                done[key] = res
                print(_fmt_cell(res), flush=True)
                with open(args.out, "w") as f:
                    json.dump(list(done.values()), f, indent=1)

    n_ok = sum(1 for r in done.values() if r["status"] == "ok")
    n_skip = sum(1 for r in done.values() if r["status"] == "skipped")
    n_err = sum(1 for r in done.values() if r["status"] == "error")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors ==")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
