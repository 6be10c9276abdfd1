"""Training substrate of the port (counterpart of ``repro.training``):
AdamW, the LR schedule and the train step."""
from .optim import adamw_init, adamw_update, global_norm
from .schedule import warmup_cosine
from .train_step import (TrainState, init_train_state, loss_fn,
                         make_train_step, place_batch, place_state)

__all__ = ["adamw_init", "adamw_update", "global_norm", "warmup_cosine",
           "make_train_step", "loss_fn", "TrainState", "init_train_state",
           "place_state", "place_batch"]
