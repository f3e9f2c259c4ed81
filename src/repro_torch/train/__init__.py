"""repro_torch.train — the train step (on one device and sharded over a
mesh of ranks), checkpoints, elastic resharding and the
trainer-as-taskflow (torch port of ``repro.train``)."""
from .checkpoint import CheckpointManager
from .elastic import reshard_state
from .train_step import (batch_shardings, make_train_step, opt_shardings,
                         param_shardings)
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "make_train_step", "Trainer",
           "TrainerConfig", "reshard_state", "param_shardings",
           "opt_shardings", "batch_shardings"]
