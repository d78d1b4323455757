"""Training of the port: the step and its optimizer."""

from .step import (
    TrainState,
    create_train_state,
    current_learning_rate,
    make_loss_fn,
    make_optimizer,
    make_resilient_step,
    make_train_step,
    multistep_lr,
    set_learning_rate,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "current_learning_rate",
    "make_loss_fn",
    "make_optimizer",
    "make_resilient_step",
    "make_train_step",
    "multistep_lr",
    "set_learning_rate",
]
