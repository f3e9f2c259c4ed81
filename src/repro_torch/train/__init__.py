"""repro_torch.train — the train step, checkpoints and the
trainer-as-taskflow (torch port of ``repro.train`` on one device)."""
from .checkpoint import CheckpointManager
from .train_step import make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "make_train_step", "Trainer",
           "TrainerConfig"]
