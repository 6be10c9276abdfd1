"""Train step on one device (port of ``repro.training.train_step``): the
loss, ``torch.autograd`` over :func:`transformer.forward_train`, optional
error-feedback int8 gradient compression, and the AdamW update.

The step is a function ``train_step(state, batch) -> (state, metrics)``
of a state ``{"params", "opt": {"m", "v", "step"}, "step"}`` (+ ``"ef"``
with compression), the reference's layout, so a checkpoint of either
package loads into the other's state.  It returns a new state and leaves
the given one as it was.  There is no mesh: the reference's data and
model parallelism (DESIGN.md §5) waits for ``torch.distributed``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

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


def make_train_step(cfg: ArchConfig, *, lr_fn: Optional[Callable] = None,
                    grad_compress: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    ``loss``, ``nll``, ``lr`` and ``grad_norm`` (0-dim tensors on the
    state's device).  The forward runs in the params' dtype (f32 masters
    from :func:`init_train_state`); ``lr_fn(step)`` defaults to
    :func:`warmup_cosine`."""
    lr_fn = lr_fn or warmup_cosine

    def train_step(state: TrainState, batch) -> tuple:
        flat = [x.detach().requires_grad_() for x in leaves(state["params"])]
        params = unflatten(state["params"], flat)
        logits, aux = T.forward_train(params, cfg, batch)
        loss, nll = loss_fn(logits, batch["labels"], aux)
        del logits
        # a leaf the batch never reaches (the token embedding of a batch
        # of embeddings) gets zeros, as under jax.grad
        grads = unflatten(state["params"], torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True))
        del params, flat
        ef = state.get("ef")
        if grad_compress and ef is not None:
            from ..distributed.compression import ef_int8_compress
            grads, ef = ef_int8_compress(grads, ef)
        lr = lr_fn(state["step"])
        params, opt, m = adamw_update(grads, state["opt"], state["params"],
                                      lr)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        if ef is not None:
            new_state["ef"] = ef
        metrics = {"loss": loss.detach(), "nll": nll.detach(), "lr": lr, **m}
        return new_state, metrics

    return train_step
