"""Train step (port of ``repro.training.train_step``): the loss,
``torch.autograd`` over :func:`transformer.forward_train`, optional
error-feedback int8 gradient compression, and the AdamW update.

The step is a function ``train_step(state, batch) -> (state, metrics)``
of a state ``{"params", "opt": {"m", "v", "step"}, "step"}`` (+ ``"ef"``
with compression), the reference's layout, so a checkpoint of either
package loads into the other's state.  It returns a new state and leaves
the given one as it was.

On one device the state holds plain tensors.  With a ``mesh`` (a
``DeviceMesh``; DESIGN.md §5: DP over (pod, data), Megatron TP over
model) the step runs under ``TRAIN_RULES``: the state's leaves are
DTensors laid out by ``launch.shardings.state_shardings``
(:func:`place_state`, TP by param name + FSDP over the data axes), the
batch by ``batch_shardings`` (:func:`place_batch`), the model's
``logical`` sites redistribute its activations, DTensor's propagation
puts in the collectives, and each gradient is brought to its param's
layout before the update.  The metrics come back as full tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..distributed.sharding import (TRAIN_RULES, is_dtensor, logical,
                                    sharded_region)
from ..models import transformer as T
from ..models.config import ArchConfig
from ..tree import leaves, tree_map, unflatten
from .optim import adamw_init, adamw_update
from .schedule import warmup_cosine

TrainState = Dict  # {"params", "opt", "step"} (+ "ef" with compression)


def init_train_state(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                     grad_compress: bool = False, device=None) -> TrainState:
    """Fresh params (``transformer.init_params`` from ``seed`` on
    ``device``: CUDA by default, raising without a card unless ``"cpu"``),
    zero AdamW moments, step 0; with ``grad_compress`` the f32
    error-feedback residuals, one per param."""
    params = T.init_params(cfg, seed=seed, dtype=dtype, device=device)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=params["embed"].device)}
    if grad_compress:
        state["ef"] = tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params)
    return state


def loss_fn(logits, labels, aux=0.0, z_coef=1e-4, aux_coef=1e-2):
    """Causal LM cross-entropy in f32 + z-loss + MoE aux: (loss, nll).

    ``labels`` are already next-token aligned (labels[t] = tokens[t+1], as
    the data loader emits them): no shift here."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold).mean()
    zloss = torch.square(lse).mean()
    return nll + z_coef * zloss + aux_coef * aux, nll


def place_state(state: TrainState, mesh, fsdp: bool = True) -> TrainState:
    """A state of full tensors (the same on every rank: one seed's init
    or a loaded checkpoint) as DTensors laid out by ``state_shardings``;
    each rank keeps its shards of the same values, so a sharded run starts
    from the one-device state bit for bit."""
    from ..launch.shardings import place, state_shardings
    return place(state, state_shardings(state, mesh, fsdp=fsdp), mesh)


def place_batch(batch, mesh):
    """A global batch (the same on every rank, such as
    ``DataLoader.batch_at(step)``) laid out by ``batch_shardings``."""
    from ..launch.shardings import batch_shardings, place
    return place(batch, batch_shardings(batch, mesh), mesh)


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def _unshard(params, mesh):
    """The params in their TP layout (``state_shardings`` without FSDP):
    FSDP's all-gather over the data axes before use.  Its backward
    reduce-scatters each gradient back to the FSDP layout."""
    from ..distributed.sharding import redistribute
    from ..launch.shardings import state_shardings
    return tree_map(lambda x, s: redistribute(x, s, mesh), params,
                    state_shardings(params, mesh, fsdp=False))


def _like_param(g, p):
    """The gradient in its param's layout (a partial sum is reduced)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ArchConfig, *, lr_fn: Optional[Callable] = None,
                    compute_dtype=None, grad_compress: bool = False,
                    mesh=None, rules=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    ``loss``, ``nll``, ``lr`` and ``grad_norm`` (0-dim tensors on the
    state's device).  The forward runs in the params' dtype (f32 masters
    from :func:`init_train_state`), or in ``compute_dtype`` (the
    reference's mixed precision: the params cast at use, the gradients
    back in the masters' dtype); ``lr_fn(step)`` defaults to
    :func:`warmup_cosine`.  With ``mesh``, the state is laid out on it
    (:func:`place_state`), a batch of plain tensors is placed by
    :func:`place_batch`, and the step runs under ``rules`` (default
    ``TRAIN_RULES``; the dry-run's sequence-parallel variant gives
    ``SEQ_PARALLEL_TRAIN_RULES``)."""
    lr_fn = lr_fn or warmup_cosine

    def train_step(state: TrainState, batch) -> tuple:
        if mesh is not None and not is_dtensor(batch["labels"]):
            batch = place_batch(batch, mesh)
        with sharded_region(mesh, rules or TRAIN_RULES):
            flat = [x.detach().requires_grad_()
                    for x in leaves(state["params"])]
            params = unflatten(state["params"], flat)
            if mesh is not None:
                params = _unshard(params, mesh)
            logits, aux = T.forward_train(params, cfg, batch,
                                          dtype=compute_dtype)
            # whole vocab rows for the loss: DTensor's masked gather of
            # vocab-sharded logits at the labels is not usable here
            logits = logical(logits, "batch", "seq", None)
            loss, nll = loss_fn(logits, batch["labels"], aux)
            del logits
            # a leaf the batch never reaches (the token embedding of a
            # batch of embeddings) gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
            if mesh is not None:
                grads = [_like_param(g, p) for g, p in zip(grads, flat)]
            grads = unflatten(state["params"], grads)
            del params, flat
            ef = state.get("ef")
            if grad_compress and ef is not None:
                from ..distributed.compression import ef_int8_compress
                grads, ef = ef_int8_compress(grads, ef)
            lr = lr_fn(state["step"])
            params, opt, m = adamw_update(grads, state["opt"],
                                          state["params"], lr)
            new_state = {"params": params, "opt": opt,
                         "step": state["step"] + 1}
            if ef is not None:
                new_state["ef"] = ef
            metrics = {"loss": loss.detach(), "nll": nll.detach(), "lr": lr,
                       **m}
            if mesh is not None:
                metrics = {k: _full(v) for k, v in metrics.items()}
        return new_state, metrics

    return train_step
