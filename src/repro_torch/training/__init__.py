from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.loss import accuracy, lm_loss, softmax_nll, softmax_xent
from repro_torch.training.optimizers import Optimizer, adam, adamw, clip_by_global_norm, cosine_schedule, sgd
from repro_torch.training.train_step import (
    TrainState,
    gather_train_state,
    init_train_state,
    make_grad_step,
    make_loss_fn,
    make_serve_step,
    make_train_step,
    shard_train_state,
)

__all__ = [
    "Optimizer",
    "TrainState",
    "accuracy",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "cosine_schedule",
    "gather_train_state",
    "init_train_state",
    "lm_loss",
    "load_checkpoint",
    "make_grad_step",
    "make_loss_fn",
    "make_serve_step",
    "make_train_step",
    "save_checkpoint",
    "sgd",
    "shard_train_state",
    "softmax_nll",
    "softmax_xent",
]
