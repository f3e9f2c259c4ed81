"""Feed-forward layers: SwiGLU (gated) and plain-GELU variants.

Counterpart of ``repro.models.mlp``. Under serve TP a rank holds column
slices of ``wi/wg`` and ``wd``: the hidden columns and the output columns
are reassembled with shape-keyed tiled all-gathers, as in the reference
(:func:`repro_torch.distributed.sharding.gather_tp`, the identity off a
group). The reference's ``constrain`` hooks (training layouts) are
dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import gather_tp
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
    if h.shape[-1] != wd.shape[0]:     # serve TP: concat local d_ff columns
        h = gather_tp(h, -1)
    y = h @ wd
    if y.shape[-1] != cfg.d_model:     # serve TP: concat wd columns
        y = gather_tp(y, -1)
    return y
