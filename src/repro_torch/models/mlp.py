"""Feed-forward layers: SwiGLU (gated) and plain-GELU variants.

Counterpart of ``repro.models.mlp``. Under serve TP a rank holds column
slices of ``wi/wg`` and ``wd``: the hidden columns and the output columns
are reassembled with shape-keyed tiled all-gathers, as in the reference
(:func:`repro_torch.distributed.sharding.gather_tp`, the identity off a
group). In the partitioned train step ``wi/wg`` are column-parallel and
``wd`` row-parallel (:func:`repro_torch.models.layers.column_parallel`,
:func:`~repro_torch.models.layers.row_parallel`): the layouts the
reference's ``constrain`` hooks give XLA; the MoE layer's shared experts
and dense residual take their partial (``partial``) to sum it with its
experts' in one reduction.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import gather_tp
from .layers import column_parallel, dtype_of, row_parallel

__all__ = ["mlp"]


def mlp(p, x: torch.Tensor, cfg: ModelConfig, prefix: str = "",
        partial: bool = False, kind: str = "mlp") -> torch.Tensor:
    """With ``partial`` (the partitioned MoE layer), ``x`` has entered the
    ``tp`` region already and the row-parallel product comes back unsummed:
    the caller adds it to its other partials before one sum over ``tp``.
    ``kind``: the layer kind whose partition the products follow (a MoE
    layer's shared experts and dense residual are ``moe``)."""
    cdt = dtype_of(cfg.compute_dtype)
    wi = p[prefix + "wi"].to(cdt)      # no-op for weights cast at load
    wd = p[prefix + "wd"].to(cdt)
    ws = (p[prefix + "wg"].to(cdt), wi) if cfg.mlp_gated else (wi,)
    cols = [x @ w for w in ws] if partial \
        else column_parallel(x, *ws, kind=kind)
    if cfg.mlp_gated:
        h = F.silu(cols[0]) * cols[1]
    else:
        h = F.gelu(cols[0], approximate="tanh")   # jax.nn.gelu default
    if partial:
        return h @ wd
    if h.shape[-1] != wd.shape[0]:     # serve TP: concat local d_ff columns
        h = gather_tp(h, -1)
    y = row_parallel(h, wd, kind=kind)
    if y.shape[-1] != cfg.d_model:     # serve TP: concat wd columns
        y = gather_tp(y, -1)
    return y
