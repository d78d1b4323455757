"""Training of the port: the step and its optimizer, the curriculum
stage drivers, their schedulers, online hard-mining cache, checkpoints
and TensorBoard writer."""

from .checkpoint import load_params, load_state, save_params, save_state
from .online_cache import OnlineCache
from .schedule import CurriculumScheduler, Stage3Scheduler
from .stages import StageConfig, train_stage1, train_stage2, train_stage3
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
from .tensorboard import SummaryWriter

__all__ = [
    "CurriculumScheduler",
    "OnlineCache",
    "Stage3Scheduler",
    "StageConfig",
    "SummaryWriter",
    "TrainState",
    "create_train_state",
    "current_learning_rate",
    "load_params",
    "load_state",
    "make_loss_fn",
    "make_optimizer",
    "make_resilient_step",
    "make_train_step",
    "multistep_lr",
    "save_params",
    "save_state",
    "set_learning_rate",
    "train_stage1",
    "train_stage2",
    "train_stage3",
]
