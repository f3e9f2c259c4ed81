"""What a step costs, counted op by op on the meta device (the port's
counterpart of ``repro.distributed.hlo_analysis``).

The reference compiles its step with XLA and parses the optimized HLO text:
FLOPs of every ``dot`` and convolution, fusion-boundary bytes, collective
bytes by type, and while-loop trip counts recovered from the loop
condition, since ``cost_analysis()`` counts a loop body once. The port has
no HLO: its step is Python that calls PyTorch ops. So this module runs the
step itself, on tensors of the ``meta`` device (shapes and dtypes, no
storage, nothing launched), under a ``TorchDispatchMode`` that sees every
ATen op the step issues, the backward's included:

* FLOPs: ``2 * M * N * K`` per ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
  (``matmul``, ``linear`` and ``einsum`` reach these), and a convolution
  as the reference counts it, ``2 * numel(result) * (C_in / groups) *
  prod(kernel)``; a convolution's backward per gradient it forms;
* bytes accessed: every non-view op's tensor inputs and outputs (no fusion
  here: the eager port reads and writes each op's operands);
* transcendentals: the elements of every exp, log, tanh, sigmoid, sqrt,
  rsqrt, pow, sin and cos result;
* collectives: the step's group is :class:`DryMeshGroup` or
  :class:`DryTPGroup`, stand-ins that return meta tensors of the gathered,
  scattered or reduced shape and only record. Each collective is counted
  by its type with the reference's size convention (the larger of its
  operand and result), by the link it crosses (``pod`` axes leave the
  node), and in the live group's own counters, so a dry counter equals a
  live run's;
* memory: the bytes of live meta storage, arguments included, after every
  op; the peak stands in for ``memory_analysis()``'s argument plus temp
  bytes.

A meta kernel is Python for most ops, and a step repeats a handful of op
shapes thousands of times (layers, microbatches, attention chunks): the
result's shape, strides and dtype of a functional op (no view, no in-place
write) are kept by its arguments' and reused, so a repeat costs an
``empty_strided``.

A Python loop runs every trip, data-dependent or not, so the reference's
trip-count problem does not arise here: ``unknown_trip_loops`` stays 0 and
is kept for the record's shape. What a meta run cannot see is what the data
decides (a loop bound read from a meta tensor raises; one read from a CPU
tensor's data runs, and counts, the trips it decides).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .sharding import MeshGroup, TPGroup

__all__ = ["StepCost", "analyze_step", "DryMeshGroup", "DryTPGroup",
           "replicated_flops",
           "COLLECTIVES"]

#: the reference's collective types (``hlo_analysis._COLLECTIVES``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
_TRANSCENDENTAL = {_aten.exp.default, _aten.log.default, _aten.tanh.default,
                   _aten.sigmoid.default, _aten.sqrt.default,
                   _aten.rsqrt.default, _aten.sin.default, _aten.cos.default,
                   _aten.pow.Tensor_Scalar, _aten.pow.Tensor_Tensor,
                   _aten.exp_.default, _aten.log1p.default}


@dataclasses.dataclass
class StepCost:
    """One step's cost on one rank (``analyze_step``)."""
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    #: the largest single collective of each type
    collective_max_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    #: collective bytes by link: ``nvlink`` (inside a node) or
    #: ``internode`` (a ``pod`` axis)
    link_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"nvlink": 0.0, "internode": 0.0})
    #: a Python loop runs every trip: always 0 (the reference's shape)
    unknown_trip_loops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def record_collective(self, kind: str, nbytes: int,
                          internode: bool = False) -> None:
        self.collective_bytes[kind] += nbytes
        self.collective_counts[kind] += 1
        self.collective_max_bytes[kind] = max(self.collective_max_bytes[kind],
                                              nbytes)
        self.link_bytes["internode" if internode else "nvlink"] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> float:
    if func in (_aten.mm.default, _aten.bmm.default):
        a, b = args[0], args[1]
    else:                                  # addmm, baddbmm: (bias, a, b)
        a, b = args[1], args[2]
    return 2.0 * a.numel() * b.shape[-1]   # 2 * (B) * M * K * N


def _conv_flops(out_shape, weight) -> float:
    """``weight`` is (C_out, C_in / groups, *kernel)."""
    return 2.0 * math.prod(out_shape) * math.prod(weight.shape[1:])


class _Counter(TorchDispatchMode):
    """Counts every op of the step into ``cost`` and tracks live storage."""

    def __init__(self, cost: StepCost) -> None:
        super().__init__()
        self.cost = cost
        self.live: Dict[int, int] = {}
        self.now = 0
        #: (op, argument key) -> the results' (shape, stride, dtype), or
        #: None for an op whose result must come from its kernel
        self.memo: Dict[Any, Any] = {}

    def _run(self, func, args, kwargs):
        """``func``'s result: from the memo for a functional op already
        seen with arguments of the same metadata, else its meta kernel."""
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:                  # an argument with no key
            return func(*args, **kwargs)
        meta = self.memo.get(key, False)
        if meta is False:
            out = func(*args, **kwargs)
            meta = None
            if _functional(func) and (isinstance(out, torch.Tensor) or (
                    isinstance(out, (tuple, list)) and out and all(
                        isinstance(t, torch.Tensor) for t in out))):
                one = isinstance(out, torch.Tensor)
                meta = (one, tuple((t.shape, t.stride(), t.dtype)
                                   for t in ((out,) if one else out)))
            self.memo[key] = meta
            return out
        if meta is None:
            return func(*args, **kwargs)
        one, metas = meta
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in metas]
        return outs[0] if one else tuple(outs)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        c = self.cost
        outs = list(_tensors_in(out))
        if func in _MATMULS:
            c.flops += _matmul_flops(func, args)
        elif func is _aten.convolution.default:
            c.flops += _conv_flops(outs[0].shape, args[1])
        elif func is _aten.convolution_backward.default:
            # grad_output, input, weight, ..., output_mask: one product per
            # gradient of the input and of the weight it forms
            c.flops += sum(args[10][:2]) * _conv_flops(args[0].shape,
                                                       args[2])
        elif func in _TRANSCENDENTAL:
            c.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view:
            c.bytes_accessed += sum(_nbytes(t) for t in _tensors_in(args)) \
                + sum(_nbytes(t) for t in _tensors_in(kwargs)) \
                + sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


def _functional(func) -> bool:
    """True for an op whose results are fresh tensors (no alias of an
    argument, no argument written)."""
    sch = func._schema
    return not func.is_view and not sch.is_mutable and all(
        r.alias_info is None for r in sch.returns)


def _tensors_in(x):
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, (list, tuple, dict)):
                yield from _tensors_in(v)
    elif isinstance(x, dict):
        yield from _tensors_in(list(x.values()))


def _key(x):
    """A hashable key of an argument tree's metadata (tensors by device,
    shape, stride, storage offset and dtype); TypeError for anything it
    cannot key."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":        # data: its op runs for real
            raise TypeError("a tensor with data")
        return (x.shape, x.stride(), x.storage_offset(), x.dtype)
    if x is None or isinstance(x, str):
        return x
    if isinstance(x, (bool, int, float)):     # 1, 1.0 and True differ
        return (x.__class__, x)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return ("d",) + tuple((k, _key(v)) for k, v in sorted(x.items()))
    if isinstance(x, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return (type(x).__name__, x)
    raise TypeError(type(x))


def analyze_step(fn: Callable, *meta_args: Any,
                 cost: Optional[StepCost] = None) -> StepCost:
    """Run ``fn(*meta_args)`` (tensors on the ``meta`` device; a CPU
    tensor's ops run for real, so a loop its data bounds counts the trips
    it ran) and count it into ``cost`` (default a new :class:`StepCost`;
    pass the one a :class:`DryMeshGroup` or :class:`DryTPGroup` inside
    ``fn`` records its collectives in). Returns the cost; ``fn``'s result is dropped after
    its bytes are counted."""
    cost = cost if cost is not None else StepCost()
    mode = _Counter(cost)
    for t in tree_flatten(meta_args)[0]:
        if isinstance(t, torch.Tensor):
            mode.track(t)
    cost.argument_bytes = mode.now
    with mode:
        out = fn(*meta_args)
    cost.output_bytes = sum(_nbytes(t) for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor))
    return cost


def replicated_flops(cfg: Any, batch: int, seq: int, tp: int,
                     kind: str = "train") -> float:
    """The FLOPs of a partitioned step's products that every one of ``tp``
    ranks forms whole, for ``batch`` rows a rank: ``seq`` tokens each (and
    a frontend's frames before each) in the train and prefill steps, one
    in the decode step. They are a MoE layer's router (``D x E``) and
    shared gate (``D x 1``), which stay in the replicated region; a Mamba2
    layer's ``B`` and ``C`` columns of ``in_proj`` (in a serve step that
    exchanges the product instead, :func:`~repro_torch.distributed.
    sharding.exchange_products`, each rank forms its share), and its
    SSD's ``C
    B^T`` a chunk (train, prefill) or its conv window's ``B`` and ``C``
    channels (decode, a product there), which every head reads; and
    attention where it runs whole
    (:func:`~repro_torch.distributed.sharding.tp_whole`): its projections,
    and in the train and prefill steps its scores and probabilities times
    values (a decode's scores are cut over the cache's sequence-parallel
    ranks, each rank scoring its keys). ``kind="train"`` counts each
    forward product, its recompute under ``remat`` and two gradient
    products (of each operand); the serve steps the forward alone. A
    rank's FLOPs are then ``(F1 - R) / tp + R``, F1 one device's for the
    same rows. Another layer kind run whole raises: its work is not
    counted here."""
    from .sharding import exchange_products, tp_whole
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown step kind {kind!r}")
    whole = tp_whole(cfg, tp)
    if set(whole) - {"attn"}:
        raise ValueError(f"{cfg.name} on {tp} ranks runs {sorted(whole)} "
                         "whole; only whole attention is counted")
    decode = kind == "decode"
    S = 1 if decode else \
        seq + (cfg.frontend_tokens if cfg.frontend != "none" else 0)
    rows = batch * S
    D, L = cfg.d_model, cfg.num_layers
    R = 0.0
    if cfg.moe:
        n = cfg.num_experts + cfg.moe_expert_pad \
            + (1 if cfg.shared_expert_d_ff else 0)
        R += 2.0 * rows * D * n * L
    if cfg.ssm and cfg.ssm_version == 2:
        N = cfg.ssm_state
        if decode:
            mix = 2.0 * rows * cfg.ssm_conv * 2 * N
        else:
            chunk = min(cfg.ssm_chunk, S)
            chunk = S if S % chunk else chunk
            mix = 2.0 * rows * chunk * N
        # B and C's columns of in_proj, unless a serve step exchanges
        # the products of the stored blocks (each rank forming its share)
        cols = 0.0 if kind != "train" and exchange_products(cfg, rows) \
            else 2.0 * rows * D * 2 * N
        R += (cols + mix) * L
    if "attn" in whole:
        H, KV, hd, cq = (cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                         cfg.attn_chunk_q)
        Sq = S if S <= cq or (S % cq and S <= 8192) else S + (-S) % cq
        n_attn = L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else L
        R += (2.0 * rows * D * (2 * H + 2 * KV) * hd
              + (0.0 if decode else 4.0 * batch * H * Sq * S * hd)) * n_attn
    if kind != "train":
        return R
    return (4 if cfg.remat else 3) * R


class DryMeshGroup(MeshGroup):
    """A :class:`MeshGroup` for the dry run: no process group; every
    collective returns a meta tensor of its result's shape, is counted as
    the live group counts it (:meth:`counters`) and is recorded in
    ``cost`` (None: counted only)."""

    def __init__(self, mesh, rank: int, cost: Optional[StepCost] = None
                 ) -> None:
        super().__init__(mesh, rank, "meta")
        self.cost = cost

    def _pg(self, axes: Sequence[str]):
        axes = tuple(axes)
        if axes != tuple(a for a in self.mesh.axis_names if a in axes):
            raise ValueError(f"axes {axes} are not in the order of "
                             f"{self.mesh}")
        return None if self.mesh.axis_size(axes) == 1 else axes

    def _record(self, kind: str, nbytes: int, axes) -> None:
        if self.cost is not None:
            self.cost.record_collective(kind, nbytes, "pod" in axes)

    def all_gather(self, x, axes, dim):
        axes = self._pg(axes)
        if axes is None:
            return x
        n = self.mesh.axis_size(axes)
        shape = list(x.shape)
        shape[dim] *= n
        self.count("all_gather", _nbytes(x) * n)
        self._record("all-gather", _nbytes(x) * n, axes)
        return x.new_empty(shape)

    def reduce_scatter(self, x, axes, dim):
        axes = self._pg(axes)
        if axes is None:
            return x
        n = self.mesh.axis_size(axes)
        shape = list(x.shape)
        shape[dim] //= n
        self.count("reduce_scatter", _nbytes(x))
        self._record("reduce-scatter", _nbytes(x), axes)
        return x.new_empty(shape)

    def all_reduce(self, x, axes=None, op: str = "sum"):
        axes = self._pg(self.mesh.axis_names if axes is None else axes)
        if axes is None:
            return x
        self.count(f"all_reduce_{op}", _nbytes(x))
        self._record("all-reduce", _nbytes(x), axes)
        return x

    def all_to_all(self, x, axes, send, recv):
        axes = self._pg(axes)
        if axes is None:
            return x
        self.count("all_to_all", _nbytes(x))
        self._record("all-to-all", _nbytes(x), axes)
        return x.new_empty((sum(recv),) + tuple(x.shape[1:]))

    def barrier(self) -> None:
        if self._pg(self.mesh.axis_names) is not None:
            self.count("barrier", 0)


class DryTPGroup(TPGroup):
    """A serve :class:`TPGroup` for the dry run: the model's all-gathers
    return meta tensors and are counted and recorded in ``cost``."""

    def __init__(self, rank: int, world: int,
                 cost: Optional[StepCost] = None) -> None:
        super().__init__(rank, world, "meta")
        self.cost = cost

    def all_gather(self, x, dim: int = -1):
        shape = list(x.shape)
        shape[dim] *= self.world
        nbytes = _nbytes(x) * self.world
        self.count("all_gather", nbytes)
        if self.cost is not None:
            self.cost.record_collective("all-gather", nbytes)
        return x.new_empty(shape)
