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
MeshGroup`, and runs its losses inside a :class:`~repro_torch.
distributed.sharding.TrainRegion` (``use_region``):

* on a ``model`` axis above 1 (:func:`~repro_torch.distributed.sharding.
  tp_compute`) the products are partitioned over ``tp`` as the
  reference's ``constrain`` hooks lay them out, each layer kind where
  ``tp`` divides the widths it cuts (:func:`~repro_torch.distributed.
  sharding.tp_whole`): each leaf the rule table shards on ``tp`` stays
  this rank's block and is gathered along ``fsdp`` only (:func:`tp_plan`);
  the layers run column- and row-parallel products, the vocab-parallel
  embedding, head and loss, a MoE layer's own experts (or every expert's
  slice of the hidden width) beside its column- and row-parallel shared
  experts and dense residual, Mamba1 on ``dI / tp`` channels and Mamba2
  on ``nh / tp`` heads (a fused Mamba leaf, stored in contiguous blocks,
  is brought to the layout the layer computes with by one all-to-all over
  ``tp``, its gradient back by another: Mamba1's ``in_proj`` to ``[x_r |
  z_r]``, Mamba2's to ``[z_r | x_r | B | C | dt_r]`` and its conv to
  ``[x_r | B | C]``, B and C whole on every rank and their gradients
  summed there), and zamba2's shared block gathers its column-parallel
  ``fused_proj`` output over ``tp``; where ``tp`` does not divide the KV
  heads ``wk/wv`` come whole and their gradients, like the head norms',
  are summed over ``tp``. The MoE router and shared gate come whole and
  their gradients are not summed over ``tp``: they are formed in the
  replicated region. A layer kind that runs whole (attention where ``tp``
  does not divide the query heads) has its leaves gathered whole, though
  the rule table stores them over ``tp``: every ``tp`` rank forms the same
  gradient and keeps its block of it. A mesh without a ``model`` axis
  above 1 gathers every leaf whole;
* the gather is once per microbatch, or with ``cfg.hoist_weight_gather``
  (and more than one microbatch) once a step, the leaves of two or more
  dims cast to bf16, as the reference casts its hoisted weights;
* the gradients are accumulated over the microbatches in ``accum_dtype``
  and reduced once a step: summed over the ``dp`` axes and cut to this
  rank's block (a reduce-scatter along the ``fsdp`` dimension), then
  divided by the ``dp`` size (each rank's loss is the mean over its
  rows); a ``tp`` block's gradient is its block already, and a leaf the
  rule table replicates over ``tp`` (the norms) gets the same gradient on
  every ``tp`` rank, so it is not summed there;
* the MoE layer routes over the global batch (its capacity, ranks and aux
  loss: :mod:`repro_torch.models.moe`);
* the metrics are averaged over the ``dp`` ranks (``ppl_proxy`` is formed
  from the averaged ``ce``, as from the global batch's);
* the grad norm and compression's per-tensor ``amax`` are the whole
  tensors' (:mod:`repro_torch.optim`).

The dry run's inputs (the reference's ``train_input_specs``,
``make_prefill_step`` and ``make_decode_step``) are meta tensors of one
rank's blocks (:func:`train_input_specs`): shapes and dtypes with no
storage, which :func:`repro_torch.distributed.op_analysis.analyze_step`
runs the step on.

Under a mesh the serve steps (:func:`make_prefill_step`,
:func:`make_decode_step`) run this rank's ``dp`` rows of the batch (all
rows when ``dp`` does not divide it) inside a :class:`~repro_torch.
distributed.sharding.TrainRegion`, under ``no_grad``: on a ``model`` axis
above 1 their weights are fetched and their products partitioned as the
train step's (above), the MoE layer routes over the global batch wherever
``dp`` splits the rows, and the logits are gathered whole over ``tp``.
Their cache is laid out as the reference's ``cache_shardings`` lays it
out (:func:`cache_shardings`): the KV caches' sequence dim over ``sp``
(over ``(data, model)`` where ``dp`` does not divide the rows), which
prefill reaches from its head-parallel attention by one all-to-all over
``tp`` a layer and decode reads as a flash decode across the ranks; the
SSM states on their channels or heads over ``tp``. Without a ``model``
axis above 1 every weight is gathered whole.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

import dataclasses

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed.sharding import (LEAF_KINDS, MeshGroup, NamedSharding,
                                    ShardCtx, TrainRegion, axes_of,
                                    cache_block, cache_seq_axes,
                                    cache_shardings, exchange_fused,
                                    exchange_products, fused_parts,
                                    logical_to_spec, param_specs,
                                    split_spec, tp_compute, tp_whole,
                                    use_region)
from ..models import lm
from ..models.layers import dtype_of
from ..optim.adamw import OptConfig, adamw_update
from ..optim.compress import compress_grads
from ..tree import leaves, tree_map, unflatten

__all__ = ["make_train_step", "split_microbatches", "param_shapes",
           "param_shardings", "opt_shardings", "batch_shardings",
           "train_batch_shapes", "train_input_specs", "make_prefill_step",
           "make_decode_step", "cache_shardings", "meta_blocks", "tp_plan"]

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


class _Serve:
    """What a sharded serve step runs with on ``ctx``: each leaf fetched
    from this rank's block as the train step fetches it (:func:`_fetch`,
    by :func:`tp_plan` on a ``model`` axis above 1, else gathered whole),
    and the :class:`TrainRegion` its model runs in: the ``dp`` axes where
    they split the batch's rows, ``tp`` and the kinds run whole, and the
    cache's sequence axes (:func:`repro_torch.distributed.sharding.
    cache_seq_axes`). Where a rank runs fewer token rows (``per_row`` a
    row) than ``d_model`` (:func:`repro_torch.distributed.sharding.
    exchange_products`), a fused Mamba ``in_proj`` stays this rank's
    stored block and the region's ``fused_out`` exchanges its product
    instead: a decode step moves a row of activations a sequence, not the
    weight."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx, pctx: ShardCtx,
                 batch: int, max_len: int, per_row: int):
        self.cfg, self.ctx = cfg, ctx
        pshard = param_shardings(cfg, pctx)
        self.specs = [s.spec for s in leaves(pshard)]
        self.rows = _serve_rows(ctx, batch)
        n = self.rows.stop - self.rows.start
        self.plan = tp_plan(cfg, pctx, pshard)
        self.fused_out = bool(self.plan) and exchange_products(
            cfg, n * per_row)
        if self.fused_out:
            self.plan = ["block" if h in ("xz", "zxbcdt") else h
                         for h in self.plan]
        self.tp = axes_of(ctx.tp) if self.plan else None
        self.whole = frozenset(tp_whole(cfg, ctx.axis_size("tp"))) \
            if self.plan else frozenset()
        self.dp = tuple(ctx.dp) if n < batch else ()
        self.sp = cache_seq_axes(ctx, batch)
        n = ctx.mesh.axis_size(self.sp)
        if max_len % n:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over the {n} ranks of {self.sp} on "
                             f"{ctx.mesh}")

    def __call__(self, params):
        """(the weights the model runs with, the region)."""
        local = leaves(params)
        if len(local) != len(self.specs):
            raise ValueError(f"params have {len(local)} leaves, the rule "
                             f"table {len(self.specs)}")
        group = self.ctx.group or MeshGroup(self.ctx.mesh, 0,
                                            local[0].device)
        hows = self.plan or ["whole"] * len(local)
        p = unflatten(params, [_fetch(self.cfg, group, t, s, h, self.tp)
                               for t, s, h in zip(local, self.specs, hows)])
        return p, TrainRegion(group, self.dp, self.tp, self.whole, self.sp,
                              self.fused_out)

    def logits(self, region: TrainRegion, logits: torch.Tensor):
        """The whole vocabulary's logits from this rank's columns (the
        head is vocab-parallel where it partitions)."""
        if self.tp is None or "vocab" in self.whole:
            return logits
        return region.group.all_gather(logits, self.tp, logits.dim() - 1)


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx, shape: ShapeSpec,
                      max_len: int = 0):
    """``(prefill_step, (params, batch), pshard)``: ``prefill_step(params,
    batch) -> (logits, cache)`` of this rank's rows, and meta tensors of
    one rank's blocks of the served weights (matrices in the compute
    dtype) and of the global ``shape`` batch. Under a mesh the model runs
    partitioned as the train step does (:class:`_Serve`), the logits come
    out whole, and the cache (``max(max_len, F + S)`` positions) is this
    rank's block under :func:`cache_shardings`."""
    pshard = param_shardings(cfg, ctx)
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    max_len = max(max_len, F + shape.seq_len)
    serve = _Serve(cfg, ctx, ctx, shape.global_batch, max_len,
                   F + shape.seq_len) if ctx.mesh is not None else None

    def prefill_step(params, batch):
        fe = batch.get("frontend_embeds")
        if serve is None:
            return lm.prefill(cfg, params, batch["tokens"], max_len,
                              frontend_embeds=fe)
        rows = serve.rows
        p, region = serve(params)
        with torch.no_grad(), use_region(region):
            logits, cache = lm.prefill(
                cfg, p, batch["tokens"][rows], max_len,
                frontend_embeds=None if fe is None else fe[rows])
            return serve.logits(region, logits), cache

    p = meta_blocks(param_shapes(cfg, cast=True), pshard)
    b = train_batch_shapes(cfg, shape.global_batch, shape.seq_len)
    return prefill_step, (p, b), pshard


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx, shape: ShapeSpec,
                     serve_tp_only: bool = False):
    """``(decode_step, (params, cache, token), (pshard, cshard))``: ONE new
    token of this rank's rows against a ``shape.seq_len`` cache (its
    ``pos`` is the last position), and meta tensors of one rank's weight
    blocks, its block of the cache under ``cshard``
    (:func:`cache_shardings`: its rows, its positions of every KV head
    and its SSM channels) and the global (B,) tokens. Under a mesh the
    model runs partitioned as the train step does (:class:`_Serve`), the
    attention as a flash decode across the cache's sequence-parallel
    ranks, and the logits come out whole. ``serve_tp_only`` drops the
    ``fsdp`` axis from the weights' shardings (resident model-sharded, as
    the reference's): a partitioned step then gathers no ``tp`` block."""
    B = shape.global_batch
    pctx = dataclasses.replace(ctx, fsdp=None) if serve_tp_only else ctx
    pshard = param_shardings(cfg, pctx)
    serve = _Serve(cfg, ctx, pctx, B, shape.seq_len, 1) \
        if ctx.mesh is not None else None

    def decode_step(params, cache, token):
        if serve is None:
            return lm.decode_step(cfg, params, cache, token)
        p, region = serve(params)
        with torch.no_grad(), use_region(region):
            logits, cache = lm.decode_step(cfg, p, cache, token[serve.rows])
            return serve.logits(region, logits), cache

    whole = lm.init_cache(cfg, B, shape.seq_len, device="meta")
    cshard = cache_shardings(cfg, ctx, B, whole)
    cache = cache_block(cfg, ctx, B, whole, meta=True)
    cache["pos"] = shape.seq_len - 1
    p = meta_blocks(param_shapes(cfg, cast=True), pshard)
    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    return decode_step, (p, cache, tok), (pshard, cshard)


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


def _grads_of(cfg: ModelConfig, params, region=None):
    """Loss, metrics and the gradients of every leaf of ``params``, by
    autograd through aliases of the leaves (same storage, fresh leaves), so
    the caller's tensors keep requires_grad off and an in-place update
    needs no special mode; inside the sharded step's ``region``."""
    def run(batch):
        flat = [t.detach().requires_grad_(True) for t in leaves(params)]
        with torch.enable_grad(), use_region(region):
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


#: how the partitioned step fetches a leaf and reduces its gradient:
#: ``block`` keeps this rank's ``tp`` block (gathered along ``fsdp`` only;
#: its gradient is the block's), ``whole`` gathers it whole (a leaf the
#: rule table does not shard on ``tp``, or one of a layer kind that runs
#: whole, :func:`~repro_torch.distributed.sharding.tp_whole`: every
#: ``tp`` rank forms the same gradient, of which it keeps its block),
#: ``sum`` gathers it whole and sums its gradient over ``tp`` (each rank's
#: covers only its heads), and the fused Mamba leaves (``_FUSED``) are
#: exchanged to the layout the layer computes with and back
#: (:func:`~repro_torch.distributed.sharding.exchange_fused`): ``xz``
#: Mamba1's ``in_proj``, ``zxbcdt`` Mamba2's, ``xbc`` Mamba2's conv
_FUSED = ("xz", "zxbcdt", "xbc")


def _leaf_names(tree, name: str = "") -> list:
    """The last key of every leaf's path, in leaf order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], k)]
    return [name]


def _how(cfg: ModelConfig, name: str, whole, kv_block: bool) -> str:
    kind = LEAF_KINDS.get(name)
    if kind is None or kind in whole or name in ("router", "shared_gate"):
        return "whole"     # replicated, of a kind run whole, or (the MoE
        #                    router and gate) formed in the replicated region
    if name == "in_proj":
        return "xz" if cfg.ssm_version == 1 else "zxbcdt"
    if name in ("conv_w", "conv_b") and cfg.ssm_version == 2:
        return "xbc"
    if name in ("wk", "wv", "bk", "bv"):
        return "block" if kv_block else "sum"
    return "sum" if name in ("q_norm", "k_norm") else "block"


def tp_plan(cfg: ModelConfig, ctx: ShardCtx, shardings=None) -> list:
    """Per leaf (in leaf order), how the partitioned step fetches it and
    reduces its gradient (see ``_FUSED``); [] when the step on ``ctx``
    gathers every leaf whole (:func:`repro_torch.distributed.sharding.
    tp_compute`)."""
    if not tp_compute(cfg, ctx):
        return []
    shardings = shardings if shardings is not None \
        else param_shardings(cfg, ctx)
    tp, n = axes_of(ctx.tp), ctx.axis_size("tp")
    whole = tp_whole(cfg, n)
    kv_block = cfg.num_kv_heads % n == 0
    plan = []
    for name, sh in zip(_leaf_names(shardings), leaves(shardings)):
        on_tp = any(set(axes_of(e)) & set(tp) for e in sh.spec)
        how = _how(cfg, name, whole, kv_block)
        ok = (not on_tp or LEAF_KINDS.get(name) in whole) \
            if how == "whole" else on_tp or how == "sum"
        if not ok:
            raise ValueError(f"{cfg.name}: leaf {name} with spec {sh.spec}"
                             f" cannot be fetched as {how!r} on {ctx.mesh}")
        plan.append(how)
    return plan


def _tp_dim(spec, tp) -> int:
    """The dimension of ``spec`` sharded over ``tp``."""
    return next(d for d, e in enumerate(spec) if set(axes_of(e)) & set(tp))


def _fetch(cfg: ModelConfig, group: MeshGroup, t: torch.Tensor, spec,
           how: str, tp_axes) -> torch.Tensor:
    """The leaf a partitioned step runs with, from this rank's block
    ``t`` (see ``_FUSED``): gathered whole, or its ``tp`` block gathered
    along ``fsdp`` only, a fused Mamba leaf then exchanged."""
    if how in ("whole", "sum"):
        return group.gather_leaf(t, spec)
    t = group.gather_leaf(t, spec, keep=tp_axes)
    if how == "block":
        return t
    return exchange_fused(group, t, tp_axes, _tp_dim(spec, tp_axes),
                          fused_parts(cfg, how))


def _sharded_step(cfg: ModelConfig, ctx: ShardCtx, opt: OptConfig,
                  compress: bool, microbatches: Optional[int],
                  accum_dtype: torch.dtype) -> StepFn:
    mesh = ctx.mesh
    pshard = param_shardings(cfg, ctx)
    shardings = leaves(pshard)
    specs = [s.spec for s in shardings]
    dp_axes, dp = tuple(ctx.dp), ctx.axis_size("dp")
    plan = tp_plan(cfg, ctx, pshard)
    tp_axes = axes_of(ctx.tp) if plan else None
    whole = frozenset(tp_whole(cfg, ctx.axis_size("tp"))) if plan \
        else frozenset()
    if ctx.group is None and mesh.size > 1:
        raise ValueError(f"the sharded step on {mesh} needs the ctx's "
                         "MeshGroup")

    def reduce(group, g, spec, how):
        """This rank's block of the gradient summed over ``dp`` (and over
        ``tp`` where each rank's covers its heads only)."""
        if how == "whole":
            return group.reduce_leaf(g, spec, dp_axes)
        spec_tp, rest = split_spec(spec, tp_axes)
        if how in _FUSED:
            g = exchange_fused(group, g, tp_axes, _tp_dim(spec, tp_axes),
                               fused_parts(cfg, how), inverse=True)
        elif how == "sum":
            g = group.reduce_leaf(g, spec_tp, tp_axes)
        return group.reduce_leaf(g, rest, dp_axes)

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
        hows = plan or ["whole"] * len(specs)

        def rows_of(i):
            lo = i * rows + d * r
            return {k: v[lo:lo + r] for k, v in batch.items()}

        def gathered():
            return unflatten(params, [_fetch(cfg, group, t, s, h, tp_axes)
                                      for t, s, h in zip(local, specs,
                                                         hows)])

        region = TrainRegion(group, dp_axes, tp_axes, whole)
        if mb <= 1:
            loss, met, grads = _grads_of(cfg, gathered(), region)(
                rows_of(0))
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
                    cfg, hoisted if hoisted is not None else gathered(),
                    region)(rows_of(i))
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
        for i, (s, h) in enumerate(zip(specs, hows)):   # one at a time
            out.append(reduce(group, grads[i], s, h) / dp)
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
