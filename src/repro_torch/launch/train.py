"""Training CLI of the port (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch llama3p2_1b --smoke \
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
    torchrun --nproc-per-node N -m repro_torch.launch.train ...

Draws the params from seed 0 (f32 masters), trains on
``DataLoader(SyntheticCorpus(vocab, seed=1))`` batches under
``warmup_cosine`` (peak ``--lr``, warmup a tenth of ``--steps``) and
prints the reference CLI's lines: ``step ... loss ... lr ... gnorm ...``
every ``--log-every`` steps and at the last, ``[straggler]`` lines, and
``done. straggler events: N``.  With ``--ckpt-dir`` it resumes from the
newest valid checkpoint (``[resume] from step N``), saves every
``--save-every`` steps and at the end, and saves on SIGTERM; checkpoints
are in the reference's layout, so the two CLIs resume each other's.

Fault tolerance as in the reference: a straggler monitor flags steps
slower than ``--straggler-factor`` x the median of the last 50.  The step
time here is the device's (the step is synchronised before the clock is
read), where the reference's jitted call returns at dispatch.  The device
is CUDA by default (raises without a card unless ``--device cpu``).

Without ``torchrun`` the run is one device and no process group.  Under
``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment) every rank
joins the process group (NCCL on CUDA, one card a rank by
``LOCAL_RANK``; gloo on the CPU), ``make_local_mesh()`` spans the world
as ``(world, 1)`` over ``("data", "model")`` and the step runs under
``TRAIN_RULES``, as the reference's trainer runs on its local mesh: the
state laid out by ``state_shardings`` (FSDP over ``data``), the global
batch ``dl.batch_at(step)`` by ``batch_shardings``, a resume resharded on
load.  Rank 0 alone prints and writes checkpoints (each save gathers the
state on every rank).
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..data import DataLoader, SyntheticCorpus
from ..device import resolve_device
from ..training import (init_train_state, make_train_step, place_state,
                        warmup_cosine)
from ..distributed.sharding import is_dtensor
from .mesh import init_world, make_local_mesh
from .shardings import named, state_shardings


class StragglerMonitor:
    """Flags a step slower than ``factor`` x the median of the last 50
    steps, after ``warmup`` steps."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor, self.warmup = factor, warmup
        self.times, self.flagged = [], 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = float(np.median(self.times[-50:]))
        if dt > self.factor * med:
            self.flagged += 1
            return True
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh, started = None, False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        started = not torch.distributed.is_initialized()
        dev = init_world(dev)
        mesh = make_local_mesh(dev)
    say = print if mesh is None or torch.distributed.get_rank() == 0 \
        else (lambda *a, **k: None)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    lr = functools.partial(warmup_cosine, peak_lr=args.lr,
                           warmup=max(args.steps // 10, 1), total=args.steps)
    state = init_train_state(cfg, seed=0, grad_compress=args.grad_compress,
                             device=dev)
    shardings = None
    if mesh is not None:
        shardings = named(state_shardings(state, mesh), mesh)
        state = place_state(state, mesh)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, save_every=args.save_every)
        restored = ckpt.restore_or_none(state, dev, shardings)
        if restored:
            state, start = restored["state"], restored["step"] + 1
            say(f"[resume] from step {restored['step']}")
        # labelled by the state's own step counter: the last step taken,
        # so a resume starts at the step after it
        ckpt.register_preemption_hook(
            lambda: (_local_int(state["step"]) - 1, state))

    corpus = SyntheticCorpus(cfg.vocab_size, seed=1)
    dl = DataLoader(corpus, batch=args.batch, seq=args.seq, device=dev)
    step_fn = make_train_step(cfg, lr_fn=lr, grad_compress=args.grad_compress,
                              mesh=mesh)
    mon = StragglerMonitor(args.straggler_factor)

    for step in range(start, args.steps):
        t0 = time.monotonic()
        state, metrics = step_fn(state, dl.batch_at(step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
        if mon.observe(dt):
            say(f"[straggler] step {step} took {dt:.2f}s "
                f"(median {np.median(mon.times[-50:]):.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['nll']):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms",
                flush=True)
        if ckpt:
            ckpt.maybe_save(step, state)
    if ckpt:
        ckpt.maybe_save(args.steps - 1, state)
    say(f"done. straggler events: {mon.flagged}")
    if started:
        torch.distributed.destroy_process_group()
    return state


def _local_int(x) -> int:
    """A replicated scalar's value, read on this rank alone (no
    collective: the SIGTERM hook runs it)."""
    return int(x.to_local() if is_dtensor(x) else x)


if __name__ == "__main__":
    main()
