"""The train step (torch port of ``repro.train.train_step.make_train_step``
on one device).

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients by ``torch.autograd``
(accumulated over microbatches), optional int8 gradient compression, then
AdamW, in place. Every metric stays a 0-d tensor on the device: a step
reads nothing back to the host, so a caller decides where to sync.

The reference's mesh parts (``ShardCtx``, ``param_shardings``,
``hoist_weight_gather``, ``constrain``) and its ``make_prefill_step`` /
``make_decode_step`` are not here: sharded training is ROADMAP Queue 1
item 11, the dry-run step factories item 14.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..optim.adamw import OptConfig, adamw_update
from ..optim.compress import compress_grads
from ..tree import leaves, unflatten

__all__ = ["make_train_step", "split_microbatches"]

StepFn = Callable[[Any, Dict[str, Any], Dict[str, torch.Tensor]],
                  Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]]


def split_microbatches(B: int, microbatches: Optional[int]) -> int:
    """The reference's rule on one device: ``None`` gives one sequence per
    microbatch, ``1`` disables accumulation, and a count that does not
    divide the batch steps down until it does."""
    mb = max(1, B) if microbatches is None else microbatches
    while B % mb:
        mb -= 1
    return mb


def make_train_step(cfg: ModelConfig, opt: Optional[OptConfig] = None,
                    compress: bool = False,
                    microbatches: Optional[int] = None,
                    accum_dtype: Optional[torch.dtype] = None) -> StepFn:
    """``accum_dtype``: the gradient accumulator's dtype; None is fp32, or
    bf16 for a model above 1e11 parameters, as in the reference.
    ``compress`` expects ``opt_state["err"]``
    (:func:`repro_torch.optim.init_error_state`)."""
    opt = opt or OptConfig()
    if accum_dtype is None:
        accum_dtype = torch.bfloat16 if cfg.param_count() > 1e11 \
            else torch.float32

    def grads_of(params, batch):
        # autograd runs on aliases of the masters (same storage, fresh
        # leaves), so the caller's tensors keep requires_grad off and the
        # in-place update below needs no special mode
        flat = [t.detach().requires_grad_(True) for t in leaves(params)]
        with torch.enable_grad():
            total, metrics = lm.loss_fn(cfg, unflatten(params, flat), batch)
            grads = torch.autograd.grad(total, flat)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        mb = split_microbatches(B, microbatches)
        if mb <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=accum_dtype)
                     for p in leaves(params)]
            mets = []
            for i in range(mb):
                l, met, g = grads_of(params, {k: v[i]
                                              for k, v in split.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(accum_dtype) / mb)
                del g
                mets.append(dict(met, loss=l))
            metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0)
                       for k in mets[0]}
            loss = metrics.pop("loss")
        grads = unflatten(params, list(grads))
        if compress:
            grads, new_err = compress_grads(grads, opt_state["err"])
        params, new_opt, om = adamw_update(
            params, grads, {k: opt_state[k] for k in ("m", "v", "count")},
            opt)
        if compress:
            new_opt["err"] = new_err
        return params, new_opt, dict(metrics, loss=loss, **om)

    return train_step
