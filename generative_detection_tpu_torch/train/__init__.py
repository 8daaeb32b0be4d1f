from .checkpoint import CheckpointManager
from .loop import Trainer
from .state import ClippedAdam, TrainState, create_train_state, make_optimizers
from .steps import make_eval_step, make_train_step

__all__ = [
    "CheckpointManager",
    "Trainer",
    "ClippedAdam",
    "TrainState",
    "create_train_state",
    "make_optimizers",
    "make_eval_step",
    "make_train_step",
]
