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

The dry run's inputs (the reference's ``train_input_specs``,
``make_prefill_step`` and ``make_decode_step``) are meta tensors of one
rank's blocks (:func:`train_input_specs`): shapes and dtypes with no
storage, which :func:`repro_torch.distributed.op_analysis.analyze_step`
runs the step on. Under a mesh the serve steps gather every weight whole,
as the train step does (the ``tp`` axis shards storage here), and run this
rank's ``dp`` rows of the batch (all rows when ``dp`` does not divide it).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

import dataclasses

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.sharding import (MeshGroup, NamedSharding, ShardCtx,
                                    logical_to_spec, param_specs)
from ..models import lm
from ..models.layers import dtype_of
from ..optim.adamw import OptConfig, adamw_update
from ..optim.compress import compress_grads
from ..tree import leaves, tree_map, unflatten

__all__ = ["make_train_step", "split_microbatches", "param_shapes",
           "param_shardings", "opt_shardings", "batch_shardings",
           "train_batch_shapes", "train_input_specs", "make_prefill_step",
           "make_decode_step", "meta_blocks"]

StepFn = Callable[[Any, Dict[str, Any], Dict[str, torch.Tensor]],
                  Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]]


# --------------------------------------------------------------- shardings
def param_shapes(cfg: ModelConfig, cast: bool = False) -> Any:
    """The tree of ``cfg``'s parameters as fake tensors (shapes and dtypes,
    no storage), as ``jax.eval_shape`` of the reference's init: the fp32
    masters a trainer updates (``cast=True``: matrices in the compute
    dtype, as a served model holds them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..params import init_params
    with FakeTensorMode():
        return init_params(cfg, torch.Generator(), device="cpu", cast=cast)


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


# ------------------------------------------------- the dry run's inputs
def meta_blocks(shapes: Any, shardings: Any,
                dtype: Optional[torch.dtype] = None) -> Any:
    """Meta tensors of one rank's block of each leaf of ``shapes`` (the
    whole leaf where its sharding is None), in the leaf's dtype or
    ``dtype``."""
    def block(t, sh):
        shape = tuple(t.shape) if sh is None else sh.local_shape(t.shape)
        return torch.empty(shape, dtype=dtype or t.dtype, device="meta")
    return tree_map(block, shapes, shardings)


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int
                       ) -> Dict[str, torch.Tensor]:
    """A ``batch x seq`` batch as meta tensors (tokens int32; a frontend
    arch's frames bf16), as the reference's."""
    b = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                               device="meta")}
    if cfg.frontend != "none":
        b["frontend_embeds"] = torch.empty(
            (batch, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return b


def train_input_specs(cfg: ModelConfig, ctx: ShardCtx, shape: ShapeSpec,
                      opt: Optional[OptConfig] = None,
                      compress: bool = False,
                      microbatches: Optional[int] = None):
    """``(step, (params, opt_state, batch), (pshard, oshard))``: the train
    step on ``ctx`` and meta tensors of one rank's inputs, its blocks of
    the fp32 masters and of the AdamW moments under the rule table
    (:func:`param_shardings`, :func:`opt_shardings`; compression's error
    state like the params) and the global ``shape`` batch, which the
    sharded step takes whole and cuts to its ``dp`` rows
    (:func:`batch_shardings` names those rows)."""
    opt = opt or OptConfig()
    step = make_train_step(cfg, opt, compress, microbatches, ctx=ctx)
    pshard = param_shardings(cfg, ctx)
    oshard = opt_shardings(cfg, ctx, pshard)
    shapes = param_shapes(cfg)
    mdt = dtype_of(opt.moment_dtype)
    o = {"m": meta_blocks(shapes, pshard, mdt),
         "v": meta_blocks(shapes, pshard, mdt),
         "count": torch.empty((), dtype=torch.int32, device="meta")}
    if compress:
        o["err"] = meta_blocks(shapes, pshard, torch.bfloat16)
    batch = train_batch_shapes(cfg, shape.global_batch, shape.seq_len)
    return step, (meta_blocks(shapes, pshard), o, batch), (pshard, oshard)


def _serve_rows(ctx: ShardCtx, B: int):
    """This rank's ``dp`` rows of a batch of ``B`` (a slice), all of them
    when ``dp`` does not divide ``B``."""
    dp = ctx.axis_size("dp") if ctx.mesh is not None else 1
    if dp == 1 or B % dp:
        return slice(0, B)
    r = B // dp
    d = ctx.mesh.axis_index(tuple(ctx.dp), ctx.rank)
    return slice(d * r, (d + 1) * r)


def _gather_params(ctx: ShardCtx, pshard, params):
    """Every leaf whole from this rank's blocks (the train step's gather)."""
    if ctx.mesh is None:
        return params
    group = ctx.group
    return unflatten(params, [t if sh is None else
                              group.gather_leaf(t, sh.spec)
                              for t, sh in zip(leaves(params),
                                               leaves(pshard))])


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx, shape: ShapeSpec):
    """``(prefill_step, (params, batch), pshard)``: ``prefill_step(params,
    batch) -> (logits, cache)`` of this rank's rows, and meta tensors of
    one rank's blocks of the served weights (matrices in the compute
    dtype) and of the global ``shape`` batch."""
    pshard = param_shardings(cfg, ctx)
    rows = _serve_rows(ctx, shape.global_batch)

    def prefill_step(params, batch):
        full = _gather_params(ctx, pshard, params)
        fe = batch.get("frontend_embeds")
        return lm.prefill(cfg, full, batch["tokens"][rows],
                          frontend_embeds=None if fe is None else fe[rows])

    p = meta_blocks(param_shapes(cfg, cast=True), pshard)
    b = train_batch_shapes(cfg, shape.global_batch, shape.seq_len)
    return prefill_step, (p, b), pshard


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx, shape: ShapeSpec,
                     serve_tp_only: bool = False):
    """``(decode_step, (params, cache, token), (pshard, None))``: ONE new
    token of this rank's rows against a ``shape.seq_len`` cache, read
    whole (its ``pos`` is the last position), and meta tensors of one
    rank's weight blocks, its rows of the cache and the global (B,)
    tokens. ``serve_tp_only`` drops the ``fsdp`` axis from the weights'
    shardings (resident model-sharded, as the reference's)."""
    pctx = dataclasses.replace(ctx, fsdp=None) if serve_tp_only else ctx
    pshard = param_shardings(cfg, pctx)
    rows = _serve_rows(ctx, shape.global_batch)
    n = rows.stop - rows.start

    def decode_step(params, cache, token):
        full = _gather_params(pctx, pshard, params)
        return lm.decode_step(cfg, full, cache, token[rows])

    cache = lm.init_cache(cfg, n, shape.seq_len, device="meta")
    cache["pos"] = shape.seq_len - 1
    p = meta_blocks(param_shapes(cfg, cast=True), pshard)
    tok = torch.empty((shape.global_batch,), dtype=torch.int32,
                      device="meta")
    return decode_step, (p, cache, tok), (pshard, None)


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
