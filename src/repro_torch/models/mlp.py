"""Feed-forward layers: SwiGLU (gated) and plain-GELU variants.

Counterpart of ``repro.models.mlp``. The reference's ``constrain`` /
``gather_tp`` sharding hooks are identities off a mesh and are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import dtype_of

__all__ = ["mlp"]


def mlp(p, x: torch.Tensor, cfg: ModelConfig, prefix: str = ""
        ) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    wi = p[prefix + "wi"].to(cdt)      # no-op for weights cast at load
    wd = p[prefix + "wd"].to(cdt)
    if cfg.mlp_gated:
        h = F.silu(x @ p[prefix + "wg"].to(cdt)) * (x @ wi)
    else:
        h = F.gelu(x @ wi, approximate="tanh")   # jax.nn.gelu default
    return h @ wd
