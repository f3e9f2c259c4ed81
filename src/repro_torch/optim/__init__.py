"""repro_torch.optim — AdamW and gradient compression (torch port of
``repro.optim``)."""
from .adamw import OptConfig, adamw_update, global_norm, init_opt_state, lr_at
from .compress import compress_grads, init_error_state

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_at", "compress_grads", "init_error_state"]
