"""The train step (torch port of ``repro.train.train_step``): on one device,
and sharded over a mesh of ``torch.distributed`` ranks.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients by ``torch.autograd``
(accumulated over microbatches), optional int8 gradient compression, then
AdamW, in place. Every metric stays a 0-d tensor on the device: a step
reads nothing back to the host, so a caller decides where to sync.

Under a ``ctx`` with a mesh (:class:`repro_torch.distributed.sharding.
ShardCtx`), each rank holds only its block of every parameter and AdamW
moment, as the reference's rule table places them (:func:`param_shardings`,
:func:`opt_shardings`), and takes the global batch, of which it runs its
``dp`` rows. XLA partitions the reference's step; here the step is
explicit, over the ranks' :class:`~repro_torch.distributed.sharding.
MeshGroup`:

* before a microbatch's forward every leaf is all-gathered whole; with
  ``cfg.hoist_weight_gather`` (and more than one microbatch) once a step
  instead, and the leaves of two or more dims cast to bf16, as the
  reference casts its hoisted weights;
* the gradients are accumulated over the microbatches in ``accum_dtype``
  and reduced once a step: summed over the ``dp`` axes and cut to this
  rank's block (a reduce-scatter along the ``fsdp`` dimension), then
  divided by the ``dp`` size (each rank's loss is the mean over its rows);
* the metrics are averaged over the ``dp`` ranks (``ppl_proxy`` is formed
  from the averaged ``ce``, as from the global batch's);
* the grad norm and compression's per-tensor ``amax`` are the whole
  tensors' (:mod:`repro_torch.optim`).

Ranks that differ only along ``tp`` run the same rows: the ``tp`` axis
shards storage here, not compute (ROADMAP Queue 3). Under a mesh the MoE
router's aux loss is each rank's over its rows, averaged, where the
reference's is the global batch's (Queue 3).

The reference's ``make_prefill_step`` / ``make_decode_step`` and its
dry-run input specs are not here (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (MeshGroup, NamedSharding, ShardCtx,
                                    logical_to_spec, param_specs)
from ..models import lm
from ..optim.adamw import OptConfig, adamw_update
from ..optim.compress import compress_grads
from ..tree import leaves, tree_map, unflatten

__all__ = ["make_train_step", "split_microbatches", "param_shapes",
           "param_shardings", "opt_shardings", "batch_shardings"]

StepFn = Callable[[Any, Dict[str, Any], Dict[str, torch.Tensor]],
                  Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]]


# --------------------------------------------------------------- shardings
def param_shapes(cfg: ModelConfig) -> Any:
    """The tree of ``cfg``'s parameters as fake tensors (shapes and dtypes,
    no storage), as ``jax.eval_shape`` of the reference's init."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..params import init_params
    with FakeTensorMode():
        return init_params(cfg, torch.Generator(), device="cpu", cast=False)


def param_shardings(cfg: ModelConfig, ctx: ShardCtx) -> Any:
    """A :class:`NamedSharding` per parameter (None leaves without a mesh):
    the rule table, with the layer stacks (``blocks``, ``tail_blocks``)
    under one leading unsharded dim and zamba2's ``gblocks`` under two
    (group, layer)."""
    shapes = param_shapes(cfg)
    specs = param_specs(shapes, ctx,
                        stacked_prefixes=("blocks", "tail_blocks"))
    if "gblocks" in shapes:
        specs["gblocks"] = param_specs(shapes["gblocks"], ctx,
                                       stacked_prefixes=("",), lead=2)
    return tree_map(lambda s: NamedSharding(ctx.mesh, s)
                    if ctx.mesh is not None else None, specs)


def opt_shardings(cfg: ModelConfig, ctx: ShardCtx, pshard) -> Dict[str, Any]:
    """The AdamW state shards like the parameters; ``count`` is replicated."""
    return {"m": pshard, "v": pshard,
            "count": NamedSharding(ctx.mesh, ()) if ctx.mesh is not None
            else None}


def batch_shardings(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, Any]:
    """The batch's rows over ``dp``."""
    def ns(logical):
        return NamedSharding(ctx.mesh, logical_to_spec(ctx, logical)) \
            if ctx.mesh is not None else None
    b = {"tokens": ns(("dp", None))}
    if cfg.frontend != "none":
        b["frontend_embeds"] = ns(("dp", None, None))
    return b


# --------------------------------------------------------------- the step
def split_microbatches(B: int, microbatches: Optional[int],
                       dp: int = 1) -> int:
    """The reference's rule: ``None`` gives ``B // dp`` microbatches (one
    sequence per ``dp`` rank each), ``1`` disables accumulation, and a count
    that does not divide the batch steps down until it does."""
    mb = max(1, B // dp) if microbatches is None else microbatches
    while B % mb:
        mb -= 1
    return mb


def _grads_of(cfg: ModelConfig, params):
    """Loss, metrics and the gradients of every leaf of ``params``, by
    autograd through aliases of the leaves (same storage, fresh leaves), so
    the caller's tensors keep requires_grad off and an in-place update
    needs no special mode."""
    def run(batch):
        flat = [t.detach().requires_grad_(True) for t in leaves(params)]
        with torch.enable_grad():
            total, metrics = lm.loss_fn(cfg, unflatten(params, flat), batch)
            grads = torch.autograd.grad(total, flat)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads
    return run


def make_train_step(cfg: ModelConfig, opt: Optional[OptConfig] = None,
                    compress: bool = False,
                    microbatches: Optional[int] = None,
                    accum_dtype: Optional[torch.dtype] = None,
                    ctx: Optional[ShardCtx] = None) -> StepFn:
    """``accum_dtype``: the gradient accumulator's dtype; None is fp32, or
    bf16 for a model above 1e11 parameters, as in the reference.
    ``compress`` expects ``opt_state["err"]``
    (:func:`repro_torch.optim.init_error_state`). ``ctx`` None (or without
    a mesh): the single-device step; with a mesh: the sharded step (module
    docstring), whose params and moments are this rank's blocks and whose
    batch is the global batch."""
    opt = opt or OptConfig()
    if accum_dtype is None:
        accum_dtype = torch.bfloat16 if cfg.param_count() > 1e11 \
            else torch.float32
    if ctx is not None and ctx.mesh is not None:
        return _sharded_step(cfg, ctx, opt, compress, microbatches,
                             accum_dtype)

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        mb = split_microbatches(B, microbatches)
        grads_of = _grads_of(cfg, params)
        if mb <= 1:
            loss, metrics, grads = grads_of(batch)
        else:
            split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=accum_dtype)
                     for p in leaves(params)]
            mets = []
            for i in range(mb):
                l, met, g = grads_of({k: v[i] for k, v in split.items()})
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


def _sharded_step(cfg: ModelConfig, ctx: ShardCtx, opt: OptConfig,
                  compress: bool, microbatches: Optional[int],
                  accum_dtype: torch.dtype) -> StepFn:
    mesh = ctx.mesh
    shardings = leaves(param_shardings(cfg, ctx))
    specs = [s.spec for s in shardings]
    dp_axes, dp = tuple(ctx.dp), ctx.axis_size("dp")
    if ctx.group is None and mesh.size > 1:
        raise ValueError(f"the sharded step on {mesh} needs the ctx's "
                         "MeshGroup")

    def train_step(params, opt_state, batch):
        local = leaves(params)
        group = ctx.group or MeshGroup(mesh, 0, local[0].device)
        if len(local) != len(specs):
            raise ValueError(f"params have {len(local)} leaves, the rule "
                             f"table {len(specs)}")
        B = batch["tokens"].shape[0]
        mb = split_microbatches(B, microbatches, dp)
        rows = B // mb
        if rows % dp:
            raise ValueError(f"a microbatch of {rows} rows does not split "
                             f"over {dp} dp ranks (batch {B}, {mb} "
                             "microbatches)")
        r = rows // dp
        d = mesh.axis_index(dp_axes, group.rank)

        def rows_of(i):
            lo = i * rows + d * r
            return {k: v[lo:lo + r] for k, v in batch.items()}

        def gathered():
            return unflatten(params, [group.gather_leaf(t, s)
                                      for t, s in zip(local, specs)])

        if mb <= 1:
            loss, met, grads = _grads_of(cfg, gathered())(rows_of(0))
            mets = [dict(met, loss=loss)]
            grads = list(grads)
        else:
            hoisted = None
            if cfg.hoist_weight_gather:
                # gather once a step, bf16 where ndim >= 2, as the reference
                hoisted = tree_map(lambda w: w.to(torch.bfloat16)
                                   if w.dim() >= 2 else w, gathered())
            grads, mets = None, []
            for i in range(mb):
                l, met, g = _grads_of(
                    cfg, hoisted if hoisted is not None else gathered())(
                        rows_of(i))
                if grads is None:
                    grads = [torch.zeros(gi.shape, dtype=accum_dtype,
                                         device=gi.device) for gi in g]
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(accum_dtype) / mb)
                del g
                mets.append(dict(met, loss=l))
            del hoisted
        names = sorted(k for k in mets[0] if k != "ppl_proxy")
        per = torch.stack([torch.stack([m[k].float() for k in names])
                           for m in mets])
        per = group.all_reduce(per, dp_axes) / dp
        metrics = {k: per[:, j] for j, k in enumerate(names)}
        metrics["ppl_proxy"] = torch.exp(torch.clamp(metrics["ce"],
                                                     max=20.0))
        metrics = {k: v.mean() for k, v in metrics.items()}
        loss = metrics.pop("loss")
        out = []
        for i, s in enumerate(specs):      # one full gradient at a time
            out.append(group.reduce_leaf(grads[i], s, dp_axes) / dp)
            grads[i] = None
        grads = unflatten(params, out)
        if compress:
            grads, new_err = compress_grads(grads, opt_state["err"],
                                            group=group)
        params, new_opt, om = adamw_update(
            params, grads, {k: opt_state[k] for k in ("m", "v", "count")},
            opt, shardings=shardings, group=group)
        if compress:
            new_opt["err"] = new_err
        return params, new_opt, dict(metrics, loss=loss, **om)

    return train_step
