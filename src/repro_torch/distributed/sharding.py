"""Sharding over ``torch.distributed``: the serving rules (tensor-parallel
serving) and the training rules (the FSDP/dp/tp table), kept free of JAX.

**Serving** — the port of the serving half of ``repro.distributed.sharding``
(``MeshDivisibilityError``, ``serve_attn_sharded``, ``serve_mlp_sharded``,
``validate_serve_mesh``, ``serve_param_specs``, ``serve_pool_spec``,
``gather_tp``). The reference shards with a device mesh
and ``shard_map``; here each rank is a process holding its shard, and the
serve engine (:mod:`repro_torch.serve.engine`, ``tp=``) drives them.

Sharding (as in the reference): the attention projections ``wq/wk/wv/wo``
and their biases, and the dense MLP's ``wi/wg/wd``, are split on their LAST
(output-column) dimension, one contiguous slice a rank in rank order; the
embedding, ``lm_head``, norms, routers and MoE experts stay replicated. So
each rank's product is a column slice of the single-device product, and
shards are reassembled with tiled all-gathers (concatenation in rank
order, no arithmetic): there is no all-reduce, and no reassociation of a
sum perturbs the stream. The paged KV pool is split by KV head (a rank
holds ``num_kv_heads / world`` heads), and K1/K2 run unchanged on the
rank's heads. The collectives are activation-sized; the pool is never
gathered.

Every collective goes through :meth:`TPGroup.count`, which records the
calls and the largest single collective in bytes, by kind: the stand-in
for the reference's check of the lowered HLO (zero all-reduces, every
all-gather far below a pool shard).

:func:`gather_tp` is live only inside :meth:`TPGroup.active` on the
calling thread (the counterpart of the reference's manual ``ShardCtx``
inside ``shard_map``); elsewhere it is the identity.

**Training** — the port of the rest: :class:`ShardCtx` (``dp``, ``fsdp``,
``tp``, ``sp``), :func:`logical_to_spec`, the per-leaf rule table
(:func:`_rule`, with its divisibility guard) and :func:`param_specs`. A
:class:`Mesh` is a grid of ranks in rank order (row-major over its axes,
as ``jax.make_mesh`` lays out devices in order); a spec is a plain tuple
with one entry per dimension: ``None``, a mesh axis name or a tuple of
names. :class:`NamedSharding` (a mesh and a spec) cuts a full tensor into
a rank's block and reassembles the blocks. XLA partitions the reference's
step; here each rank is a process holding its blocks, and
:class:`MeshGroup` runs the step's explicit, counted collectives over the
subgroups of each mesh axis.

The partitioned compute of the train step: on a ``model`` axis above 1
every arch partitions its products over the ``tp`` axis
(:func:`tp_compute`), each layer kind where ``tp`` divides what it cuts
(:func:`tp_whole`: dense attention, MLP, MoE, Mamba1, Mamba2 and zamba2's
shared block input; a MoE layer keeps its ``E / tp`` experts, or all
experts' ``1 / tp`` hidden width, as the rule table splits them), the
other kinds whole on every rank; inside the step's :class:`TrainRegion`
the layers call six collectives that sit in the autograd graph, each
counted by the group: into the ``tp`` region (identity forward, sum
backward), out of it (sum forward, identity backward), a sum of partial
statistics (sum both ways), the gather of a column-parallel activation
(its block back), the vocab-parallel max (no gradient) and the MoE
router's sum over ``dp``. :func:`exchange_fused` moves a fused Mamba
leaf between its stored layout and the one the partitioned layer
computes with. The sharded prefill and decode steps run in the same
region, with the decode cache laid out as the reference's
``cache_shardings`` (:func:`cache_specs`, :func:`cache_shardings`): the
KV caches' sequence dim over ``sp`` (:func:`cache_seq_axes`), whose
softmax reductions a decode sums over those ranks
(:meth:`TrainRegion.over_sp`). Where a rank runs fewer token rows than
``d_model`` they exchange a fused Mamba ``in_proj``'s product instead of
its weight (:func:`fused_product`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["MeshDivisibilityError", "serve_attn_sharded",
           "serve_mlp_sharded", "validate_serve_mesh", "shard_serve_params",
           "TPGroup", "gather_tp", "SERVE_ATTN_LEAVES", "SERVE_MLP_LEAVES",
           "Mesh", "ShardCtx", "logical_to_spec", "constrain",
           "param_specs", "NamedSharding", "axes_of", "MeshGroup",
           "TrainRegion", "use_region", "current_region", "tp_part",
           "tp_compute", "tp_compute_why", "tp_whole", "LEAF_KINDS",
           "split_spec", "exchange_fused", "fused_parts", "fused_product",
           "exchange_products", "FusedSharding",
           "KV_LEAVES", "cache_seq_axes", "cache_specs", "cache_shardings",
           "cache_block", "assemble_cache"]


class MeshDivisibilityError(ValueError):
    """Model-axis size does not divide the head/feature counts it shards."""


#: leaves sharded on their last (output-column) dim under serve TP
SERVE_ATTN_LEAVES = frozenset({"wq", "wk", "wv", "bq", "bk", "bv", "wo"})
SERVE_MLP_LEAVES = frozenset({"wi", "wg", "wd"})


def serve_attn_sharded(cfg: Any, mp: int) -> bool:
    """True when the attention cluster (and thus the KV pool) shards
    mp-way."""
    if mp <= 1 or cfg.ssm or cfg.hybrid_attn_every:
        return False
    return (cfg.num_kv_heads % mp == 0 and cfg.num_heads % mp == 0
            and cfg.d_model % mp == 0)


def serve_mlp_sharded(cfg: Any, mp: int) -> bool:
    """True when the dense-MLP cluster shards mp-way (MoE experts never
    do)."""
    if mp <= 1 or cfg.ssm or cfg.hybrid_attn_every:
        return False
    return cfg.d_ff % mp == 0 and cfg.d_model % mp == 0


def validate_serve_mesh(cfg: Any, mp: int) -> None:
    """Raise :class:`MeshDivisibilityError` for head counts mp can't shard.

    SSM/hybrid architectures are not sharded on any mesh size, so only
    attention architectures are constrained.
    """
    if mp <= 1 or cfg.ssm or cfg.hybrid_attn_every:
        return
    if not serve_attn_sharded(cfg, mp):
        raise MeshDivisibilityError(
            f"{cfg.name}: mesh model axis {mp} must divide num_kv_heads="
            f"{cfg.num_kv_heads}, num_heads={cfg.num_heads} and d_model="
            f"{cfg.d_model} to shard the KV pool by head; pick a divisor "
            "or run single-device")


def shard_serve_params(cfg: Any, params: Dict[str, Any], rank: int,
                       world: int) -> Dict[str, Any]:
    """Rank ``rank``'s shard of ``params``: the leaves of ``blocks`` named
    in :data:`SERVE_ATTN_LEAVES` (when the attention shards) and
    :data:`SERVE_MLP_LEAVES` (when the MLP shards) cut on their last
    dimension into ``world`` slices (contiguous copies); every other leaf
    is the caller's tensor. The reference's ``serve_param_specs``."""
    attn_ok = serve_attn_sharded(cfg, world)
    mlp_ok = serve_mlp_sharded(cfg, world)
    if not (attn_ok or mlp_ok):
        return params

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        if (attn_ok and name in SERVE_ATTN_LEAVES) or \
                (mlp_ok and name in SERVE_MLP_LEAVES):
            return t.chunk(world, dim=-1)[rank].contiguous()
        return t

    out = dict(params)
    out["blocks"] = {k: cut(k, v) for k, v in params["blocks"].items()}
    return out


class TPGroup:
    """The process group of a tensor-parallel serve engine, this process's
    rank in it, and the counters of its collectives.

    The model's all-gathers run on the default process group;
    ``desc_group`` is the one rank 0 broadcasts op descriptors on (None:
    the default group; give it a long timeout, since a follower waits
    there while the engine is idle). ``device``: this rank's device. ``lock`` orders, on rank 0, "broadcast a descriptor,
    run the shard" across the engine's stage threads, so every rank issues
    its collectives in one order."""

    def __init__(self, rank: int, world: int, device: Any,
                 desc_group: Any = None) -> None:
        if not 0 <= rank < world:
            raise ValueError(f"TPGroup: rank {rank} of world {world}")
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.desc_group = desc_group
        self.lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.max_bytes: Dict[str, int] = {}

    # -- the counting wrapper -------------------------------------------------
    def count(self, kind: str, nbytes: int) -> None:
        """Record one collective of ``kind`` moving ``nbytes`` (the
        gathered result for an all-gather), under ``kind`` and, inside
        :meth:`active` with a label, also under ``kind:label``."""
        label = getattr(_ACTIVE, "label", None)
        keys = (kind,) if label is None else (kind, f"{kind}:{label}")
        with self._count_lock:
            for k in keys:
                self.calls[k] = self.calls.get(k, 0) + 1
                self.max_bytes[k] = max(self.max_bytes.get(k, 0),
                                        int(nbytes))

    def counters(self) -> Dict[str, Dict[str, int]]:
        with self._count_lock:
            return {"calls": dict(self.calls),
                    "max_bytes": dict(self.max_bytes)}

    def reset_counters(self) -> None:
        with self._count_lock:
            self.calls.clear()
            self.max_bytes.clear()

    # -- collectives ---------------------------------------------------------
    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Tiled all-gather: every rank's ``x`` concatenated along ``dim``
        in rank order."""
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self.count("all_gather", x.numel() * x.element_size() * self.world)
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def send(self, op: int, key: int, arrays: Tuple[np.ndarray, ...]
             ) -> None:
        """Rank 0: broadcast one op descriptor (an op id, a key and int32
        host arrays) to the followers."""
        import torch.distributed as dist
        arrays = tuple(np.ascontiguousarray(a, dtype=np.int32)
                       for a in arrays)
        self.count("broadcast", sum(a.nbytes for a in arrays))
        dist.broadcast_object_list([(op, key, arrays)], src=0,
                                   group=self.desc_group,
                                   device=self._desc_device())

    def recv(self) -> Tuple[int, int, Tuple[np.ndarray, ...]]:
        """A follower: the next descriptor rank 0 broadcasts."""
        import torch.distributed as dist
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.desc_group,
                                   device=self._desc_device())
        op, key, arrays = box[0]
        self.count("broadcast", sum(a.nbytes for a in arrays))
        return op, key, arrays

    def _desc_device(self) -> torch.device:
        import torch.distributed as dist
        backend = dist.get_backend(self.desc_group)
        return self.device if backend == "nccl" else torch.device("cpu")

    # -- the active group of the calling thread ------------------------------
    @contextlib.contextmanager
    def active(self, label: Optional[str] = None):
        """Make :func:`gather_tp` live on this thread for the block; its
        collectives are also counted under ``label`` (an op's name)."""
        prev = (getattr(_ACTIVE, "tp", None), getattr(_ACTIVE, "label", None))
        _ACTIVE.tp, _ACTIVE.label = self, label
        try:
            yield self
        finally:
            _ACTIVE.tp, _ACTIVE.label = prev


_ACTIVE = threading.local()


def gather_tp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Reassemble per-rank output columns: a tiled all-gather along
    ``dim`` under the calling thread's active :class:`TPGroup`; the
    identity otherwise (and on a group of one)."""
    tp = getattr(_ACTIVE, "tp", None)
    if tp is None or tp.world == 1:
        return x
    return tp.all_gather(x, dim)


# --------------------------------------------------------------------------- #
# training: the mesh, the context and the rule table
# --------------------------------------------------------------------------- #

#: one dimension's entry of a spec: unsharded, one mesh axis, or several
Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def axes_of(axis: Axis) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (major to minor)."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


class Mesh:
    """A grid of ranks (the counterpart of ``jax.sharding.Mesh`` over
    devices): ``shape`` maps each axis name to its size, in order, and rank
    ``r`` sits at the row-major coordinates of ``r`` (the last axis
    fastest), as ``jax.make_mesh`` lays out devices in order. It holds no
    process group (:class:`MeshGroup` does)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or any(int(n) < 1 for n in sizes):
            raise ValueError(f"Mesh: sizes {tuple(sizes)} over axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in
                                      zip(axis_names, sizes)}
        self.size = 1
        for n in self.shape.values():
            self.size *= n

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> Dict[str, int]:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on {self}")
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def axis_index(self, axes: Sequence[str], rank: int) -> int:
        """``rank``'s position along ``axes`` taken together (the first
        axis major): the block of a dimension sharded over ``axes`` that
        it holds."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def axis_ranks(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in the
        order of :meth:`axis_index` along ``axes``."""
        base = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def axis_groups(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group of :meth:`axis_ranks` along ``axes``, in the order of
        their first rank."""
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                g = self.axis_ranks(axes, r)
                seen.update(g)
                out.append(g)
        return out


@dataclasses.dataclass
class ShardCtx:
    """The logical axes of the reference's ``ShardCtx`` over a
    :class:`Mesh` of ranks: ``dp`` (the batch), ``fsdp`` (parameter and
    optimizer state, ZeRO-3 style; may span several axes), ``tp`` and
    ``sp``. ``group``: this process's :class:`MeshGroup` (its rank, its
    device and the collectives); None for the rule table alone, or for a
    mesh of one rank."""
    mesh: Optional[Mesh]
    dp: Tuple[str, ...] = ("data",)
    fsdp: Optional[Any] = "data"
    tp: Optional[str] = "model"
    sp: Optional[str] = "model"
    group: Optional["MeshGroup"] = None

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        names = {"dp": self.dp, "fsdp": axes_of(self.fsdp),
                 "tp": axes_of(self.tp), "sp": axes_of(self.sp)}[logical]
        return self.mesh.axis_size(names)

    @property
    def rank(self) -> int:
        """This process's rank on the mesh (0 on a mesh of one)."""
        if self.group is not None:
            return self.group.rank
        if self.mesh is None or self.mesh.size == 1:
            return 0
        raise ValueError(f"a ShardCtx on {self.mesh} without a MeshGroup "
                         "has no rank of its own; pass the rank")


def logical_to_spec(ctx: ShardCtx, logical: Sequence[Any]) -> Spec:
    """Translate ('dp', None, 'tp') style logical specs to a spec tuple."""
    out: List[Axis] = []
    for a in logical:
        if a is None:
            out.append(None)
        elif a == "dp":
            out.append(ctx.dp if len(ctx.dp) > 1 else ctx.dp[0])
        elif a == "fsdp":
            out.append(ctx.fsdp)
        elif a in ("tp", "sp"):
            out.append(getattr(ctx, a))
        else:  # raw mesh axis name
            out.append(a)
    return tuple(out)


def constrain(x: Any, *logical: Any) -> Any:
    """The identity. The reference pins an activation's layout for XLA's
    partitioner with ``with_sharding_constraint``; here no compiler
    partitions the step: each rank runs its own rows, and the partitioned
    layers their own heads and channels, explicitly (:class:`TrainRegion`,
    :func:`repro_torch.train.train_step.make_train_step`), so there is
    nothing to constrain."""
    return x


def _divisible(dim: int, ctx: ShardCtx, axis) -> bool:
    if axis is None or ctx.mesh is None:
        return False
    axes = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for a in axes:
        size *= ctx.mesh.shape[a]
    return dim % size == 0


def _rule(path: str, shape: Tuple[int, ...], ctx: ShardCtx) -> Spec:
    """The spec of one parameter (path is '/'-joined key names): the
    reference's table, leaf for leaf."""
    tp, fsdp = ctx.tp, ctx.fsdp
    leaf = path.rsplit("/", 1)[-1]

    def guard(spec_axes):
        """Drop mesh axes that do not divide the dim (uneven shards)."""
        return tuple(ax if _divisible(dim, ctx, ax) else None
                     for dim, ax in zip(shape, spec_axes))

    if leaf in ("embed", "pos_embed"):
        return guard((tp, fsdp))                       # (V, D)
    if leaf == "lm_head":
        return guard((fsdp, tp))                       # (D, V)
    if leaf in ("wq", "wk", "wv", "wi", "wg", "in_proj", "dt_proj",
                "shared_wi", "shared_wg", "dense_wi", "dense_wg",
                "fused_proj"):
        return guard((fsdp, tp))                       # column parallel
    if leaf in ("wo", "wd", "out_proj", "shared_wd", "dense_wd"):
        return guard((tp, fsdp))                       # row parallel
    if leaf in ("bq", "bk", "bv"):
        return guard((tp,))
    if leaf == "router":
        return guard((fsdp, None))                     # (D, E)
    if leaf in ("e_wi", "e_wg"):                       # (E, D, F)
        if _divisible(shape[0], ctx, tp):
            return guard((tp, fsdp, None))
        return guard((None, fsdp, tp))
    if leaf == "e_wd":                                 # (E, F, D)
        if _divisible(shape[0], ctx, tp):
            return guard((tp, None, fsdp))
        return guard((None, tp, fsdp))
    if leaf in ("conv_w", "conv_b", "x_proj", "A_log", "ssm_D", "dt_bias",
                "ssm_norm"):
        return guard((tp,) + (None,) * (len(shape) - 1))  # (dI, ...)
    # norms / scalars / biases: replicated
    return (None,) * len(shape)


def param_specs(params: Any, ctx: ShardCtx, stacked_prefixes=("blocks",),
                lead: int = 1) -> Any:
    """Tree of specs matching ``params`` (nested dicts whose leaves have a
    ``shape``); leaves under a stacked prefix (the layer stack) get
    ``lead`` leading unsharded dims."""

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        shape = tuple(node.shape)
        if any(path.startswith(p) for p in stacked_prefixes):
            return (None,) * lead + _rule(path, shape[lead:], ctx)
        return _rule(path, shape, ctx)

    return visit(params, "")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    which block of a full tensor each rank holds. Dimension ``i`` is cut
    into ``mesh.axis_size(axes_of(spec[i]))`` equal contiguous blocks, and
    a rank holds the block at its :meth:`Mesh.axis_index` along those
    axes; a rank off every axis of the spec holds the whole dimension."""
    mesh: Mesh
    spec: Spec

    def _cuts(self, ndim: int):
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [axes_of(a) for a in spec]

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, axes in zip(shape, self._cuts(len(shape))):
            k = self.mesh.axis_size(axes)
            if n % k:
                raise ValueError(f"dim {n} does not divide over {axes} "
                                 f"({k} ranks) of {self.mesh}")
            out.append(n // k)
        return tuple(out)

    def shard(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """``rank``'s block of the full tensor ``t`` (a view)."""
        local = self.local_shape(t.shape)
        for d, axes in enumerate(self._cuts(t.dim())):
            if axes:
                i = self.mesh.axis_index(axes, rank)
                t = t.narrow(d, i * local[d], local[d])
        return t

    def assemble(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every rank's block (``blocks[r]`` is rank
        ``r``'s): concatenation in axis order, no arithmetic."""
        ndim = blocks[0].dim()
        cuts = self._cuts(ndim)
        # one representative rank per distinct block, then concatenate the
        # blocks dimension by dimension (the last cut dim first)
        grid = {}
        for r in range(self.mesh.size):
            key = tuple(self.mesh.axis_index(a, r) if a else 0 for a in cuts)
            grid.setdefault(key, blocks[r])
        for d in reversed(range(ndim)):
            n = self.mesh.axis_size(cuts[d]) if cuts[d] else 1
            merged = {}
            for key in sorted({k[:d] + k[d + 1:] for k in grid}):
                parts = [grid[key[:d] + (i,) + key[d:]] for i in range(n)]
                merged[key] = torch.cat(parts, dim=d) if n > 1 else parts[0]
            grid = {k[:d] + (0,) + k[d:]: v for k, v in merged.items()}
        (full,) = grid.values()
        return full

    def holds_first(self, rank: int) -> bool:
        """True for exactly one holder of each distinct block: the rank at
        coordinate 0 of every mesh axis the spec does not use (a leaf
        replicated along an axis is held by every rank on it)."""
        used = {a for entry in self.spec for a in axes_of(entry)}
        c = self.mesh.coords(rank)
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in used)

    def nbytes(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        """The bytes of one rank's block of a ``shape`` leaf."""
        n = 1
        for k in self.local_shape(shape):
            n *= k
        return n * torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class FusedSharding(NamedSharding):
    """A :class:`NamedSharding` whose blocks along the last dim are in the
    layout a partitioned layer computes with (:func:`exchange_fused`):
    part by part (``parts``, each ``(width, split)``, as
    :func:`fused_parts`), the r-th ``1 / n`` of each split part and the
    whole of every other part, r being the rank's index along the axes of
    ``spec[-1]`` and n their size. The other dims are cut as the spec
    says. Mamba2's conv buffer on a ``model`` axis: ``[x_r | B | C]``."""
    parts: Tuple[Tuple[int, bool], ...] = ()

    def _rest(self) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(self.spec[:-1]) + (None,))

    def _n(self) -> int:
        return self.mesh.axis_size(axes_of(self.spec[-1]))

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        n = self._n()
        return self._rest().local_shape(shape)[:-1] + (
            sum(w // n if split else w for w, split in self.parts),)

    def shard(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """``rank``'s block of the full tensor ``t`` (a copy)."""
        t = self._rest().shard(t, rank)
        n, r = self._n(), self.mesh.axis_index(axes_of(self.spec[-1]), rank)
        pieces, lo = [], 0
        for w, split in self.parts:
            pieces.append(t[..., lo + r * w // n:lo + (r + 1) * w // n]
                          if split else t[..., lo:lo + w])
            lo += w
        return torch.cat(pieces, dim=-1)

    def assemble(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every rank's block: each split part
        concatenated over the ranks, each whole part from the first
        holder."""
        n, cols, at = self._n(), [], 0
        for w, split in self.parts:
            k = w // n if split else w
            sh = NamedSharding(self.mesh, self.spec) if split \
                else self._rest()
            cols.append(sh.assemble([b[..., at:at + k] for b in blocks]))
            at += k
        return torch.cat(cols, dim=-1)


# --------------------------------------------------------------------------- #
# training: the collectives over the mesh's axes
# --------------------------------------------------------------------------- #

class MeshGroup:
    """This rank's place on a :class:`Mesh` of ``torch.distributed`` ranks
    and the collectives of the sharded train step over its axes, each
    counted by kind (calls, and the largest single collective in bytes) as
    :class:`TPGroup` counts the serve engine's.

    ``pgs`` maps a tuple of axis names to this rank's process group along
    those axes (:meth:`create` builds them); a collective over axes whose
    ranks number one is the identity and is not counted. On gloo every
    collective used here takes CUDA tensors (it stages them through the
    host itself), so nothing is copied here."""

    def __init__(self, mesh: Mesh, rank: int, device: Any,
                 pgs: Optional[Dict[Tuple[str, ...], Any]] = None) -> None:
        self.mesh = mesh
        self.rank = rank
        self.coords = mesh.coords(rank)
        self.device = torch.device(device)
        self.pgs = dict(pgs or {})
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.max_bytes: Dict[str, int] = {}

    @classmethod
    def create(cls, mesh: Mesh, rank: int, device: Any,
               timeout_s: float) -> Optional["MeshGroup"]:
        """Build the process groups of every combination of ``mesh``'s axes
        over world ranks ``0 .. mesh.size - 1``. Collective over the whole
        default group: every rank of it calls this with the same mesh, in
        the same order (a world rank off the mesh gets None)."""
        import datetime

        import torch.distributed as dist
        if mesh.size > dist.get_world_size():
            raise ValueError(f"{mesh} needs {mesh.size} ranks; the process "
                             f"group has {dist.get_world_size()}")
        td = datetime.timedelta(seconds=timeout_s)
        on = rank < mesh.size
        pgs = {}
        for k in range(1, len(mesh.axis_names) + 1):
            for axes in itertools.combinations(mesh.axis_names, k):
                for ranks in mesh.axis_groups(axes):
                    if len(ranks) == 1:
                        continue
                    pg = dist.new_group(ranks=ranks, timeout=td)
                    if on and rank in ranks:
                        pgs[axes] = pg
        return cls(mesh, rank, device, pgs) if on else None

    # -- counting ------------------------------------------------------------
    def count(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.max_bytes[kind] = max(self.max_bytes.get(kind, 0),
                                       int(nbytes))

    def counters(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"calls": dict(self.calls),
                    "max_bytes": dict(self.max_bytes)}

    def reset_counters(self) -> None:
        with self._lock:
            self.calls.clear()
            self.max_bytes.clear()

    # -- collectives ---------------------------------------------------------
    def _pg(self, axes: Sequence[str]):
        axes = tuple(axes)
        if axes != tuple(a for a in self.mesh.axis_names if a in axes):
            # a process group numbers its ranks in increasing order, which
            # is Mesh.axis_index's order only for axes in mesh order
            raise ValueError(f"axes {axes} are not in the order of {self.mesh}")
        if self.mesh.axis_size(axes) == 1:
            return None
        return self.pgs[axes]

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """Tiled all-gather over the ranks along ``axes``: their ``x``
        concatenated along ``dim`` in :meth:`Mesh.axis_index` order."""
        import torch.distributed as dist
        pg = self._pg(axes)
        if pg is None:
            return x
        n = self.mesh.axis_size(axes)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        self.count("all_gather", x.numel() * x.element_size() * n)
        dist.all_gather(parts, x, group=pg)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes: Sequence[str],
                       dim: int) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes``, of which this
        rank keeps its block along ``dim``."""
        import torch.distributed as dist
        pg = self._pg(axes)
        if pg is None:
            return x
        n = self.mesh.axis_size(axes)
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self.count("reduce_scatter", xt.numel() * xt.element_size())
        dist.reduce_scatter_tensor(out, xt, group=pg)
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor, axes: Optional[Sequence[str]]
                   = None, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``sum`` or ``max``) over the ranks along ``axes``
        (None: the whole mesh), in place."""
        import torch.distributed as dist
        pg = self._pg(self.mesh.axis_names if axes is None else axes)
        if pg is None:
            return x
        self.count(f"all_reduce_{op}", x.numel() * x.element_size())
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=pg)
        return x

    def all_to_all(self, x: torch.Tensor, axes: Sequence[str],
                   send: Sequence[int], recv: Sequence[int]) -> torch.Tensor:
        """The exchange over the ranks along ``axes``: ``x``'s consecutive
        slices of ``send[j]`` rows (dim 0) go to the j-th of them; the
        result is the rows received, ``recv[j]`` from the j-th, in rank
        order."""
        import torch.distributed as dist
        pg = self._pg(axes)
        if pg is None:
            return x
        x = x.contiguous()
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        self.count("all_to_all", x.numel() * x.element_size())
        dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=pg)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh reaches this point."""
        import torch.distributed as dist
        pg = self._pg(self.mesh.axis_names)
        if pg is not None:
            self.count("barrier", 0)
            dist.barrier(group=pg)

    # -- leaves --------------------------------------------------------------
    def gather_leaf(self, t: torch.Tensor, spec: Spec,
                    keep: Sequence[str] = ()) -> torch.Tensor:
        """The full tensor from this rank's block ``t`` of a leaf with
        ``spec``: one tiled all-gather per sharded dimension. The
        dimensions sharded over an axis of ``keep`` stay this rank's block
        (the partitioned step keeps its ``tp`` blocks)."""
        for d, entry in enumerate(spec):
            if axes_of(entry) and not set(axes_of(entry)) & set(keep):
                t = self.all_gather(t, axes_of(entry), d)
        return t

    def reduce_leaf(self, g: torch.Tensor, spec: Spec,
                    axes: Sequence[str]) -> torch.Tensor:
        """The sum over the ranks along ``axes`` of the full tensor ``g``,
        cut to this rank's block for ``spec``: a reduce-scatter along the
        dimension sharded over exactly ``axes`` (an all-reduce when none
        is), and a local cut along the others."""
        axes = tuple(axes)
        done = None
        for d, entry in enumerate(spec):
            if axes_of(entry) == axes:
                g = self.reduce_scatter(g, axes, d)
                done = d
                break
        if done is None:
            g = self.all_reduce(g.contiguous(), axes)
        rest = tuple(None if d == done else e for d, e in enumerate(spec))
        return NamedSharding(self.mesh, rest).shard(g, self.rank) \
            .contiguous()


# --------------------------------------------------------------------------- #
# training: the partitioned compute of the sharded step
# --------------------------------------------------------------------------- #

class _CopyToTP(torch.autograd.Function):
    """Into the ``tp`` region: the identity forward; the backward sums the
    ranks' partial gradients of the replicated input (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group, axes):
        ctx.group, ctx.axes = group, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.group.all_reduce(g, ctx.axes), None, None


class _ReduceFromTP(torch.autograd.Function):
    """Out of the ``tp`` region: the forward sums the ranks' partial
    results; the backward is the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group, axes):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MaxOverTP(torch.autograd.Function):
    """The largest of the ranks' values (the vocab-parallel max of the
    logits). It only shifts the exponentials, so it has no gradient."""

    @staticmethod
    def forward(ctx, x, group, axes):
        out = group.all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), axes, op="max")
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None, None


class _SumOverDP(torch.autograd.Function):
    """The sum over the ``dp`` ranks of a statistic of each rank's rows
    (the MoE router's per-expert sums). Every rank then holds the global
    batch's value and the same upstream gradient; the step sums the ranks'
    gradients and divides by ``dp``, so the backward scales by ``dp``: the
    summed, divided gradient is the global statistic's."""

    @staticmethod
    def forward(ctx, x, group, axes, n):
        ctx.n = n
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                axes)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None, None


class _SumOverTP(torch.autograd.Function):
    """The sum over the ``tp`` ranks of partial sums that each rank then
    reads for its own channels (Mamba2's mean of squares over ``dI``):
    each rank's gradient covers only its channels' use, so the backward
    sums them too."""

    @staticmethod
    def forward(ctx, x, group, axes):
        ctx.group, ctx.axes = group, axes
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                axes)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.group.all_reduce(g, ctx.axes), None, None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' column blocks of an activation concatenated along its
    last dim (zamba2's ``fused_proj`` output, which every rank then uses
    whole); the backward keeps this rank's block of the gradient, the same
    on every rank."""

    @staticmethod
    def forward(ctx, x, group, axes):
        ctx.n = x.shape[-1]
        ctx.lo = group.mesh.axis_index(axes, group.rank) * ctx.n
        return group.all_gather(x, axes, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lo, ctx.n).contiguous(), None, None


@dataclasses.dataclass(frozen=True)
class TrainRegion:
    """What a sharded step makes current while it runs the model
    (:func:`use_region`): the train step around its losses, the prefill
    and decode steps around ``lm.prefill`` / ``lm.decode_step``
    (:mod:`repro_torch.train.train_step`). It holds this rank's group, the
    ``dp`` axes its rows are split over (empty where every rank runs every
    row), ``tp``, the model axes its products are partitioned over (None:
    every rank runs whole weights), ``whole``, the layer kinds
    (:func:`tp_whole`) that run whole on every ``tp`` rank all the same,
    and, in the serve steps, ``sp``: the axes a decode cache's sequence
    dim is cut over (:func:`cache_seq_axes`), whose softmax statistics and
    probabilities-times-values a decode sums over them, and
    ``fused_out``: a fused Mamba ``in_proj`` comes as this rank's stored
    block, and its product is exchanged rather than the weight
    (:func:`fused_product`, :func:`exchange_products`)."""
    group: "MeshGroup"
    dp: Tuple[str, ...]
    tp: Optional[Tuple[str, ...]] = None
    whole: frozenset = frozenset()
    sp: Tuple[str, ...] = ()
    fused_out: bool = False

    @property
    def dp_size(self) -> int:
        return self.group.mesh.axis_size(self.dp)

    @property
    def tp_size(self) -> int:
        return self.group.mesh.axis_size(self.tp) if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.group.mesh.axis_index(self.tp, self.group.rank) \
            if self.tp else 0

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.group, self.tp)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.group, self.tp)

    def max_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _MaxOverTP.apply(x, self.group, self.tp)

    def sum_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOverTP.apply(x, self.group, self.tp)

    def gather_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherFromTP.apply(x, self.group, self.tp)

    def sum_over_dp(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_size == 1:
            return x
        return _SumOverDP.apply(x, self.group, self.dp, self.dp_size)

    @property
    def sp_size(self) -> int:
        return self.group.mesh.axis_size(self.sp)

    @property
    def sp_index(self) -> int:
        """The block of the cache's sequence dim this rank holds."""
        return self.group.mesh.axis_index(self.sp, self.group.rank)

    def over_sp(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``sum`` or ``max``) over the ``sp`` ranks (no
        gradient: the serve steps run under ``no_grad``)."""
        return self.group.all_reduce(
            x.clone(memory_format=torch.contiguous_format), self.sp, op)


@contextlib.contextmanager
def use_region(region: Optional[TrainRegion]):
    """Make ``region`` current on this thread for the block (the
    counterpart of the reference's ``use_shard_ctx`` in its train step)."""
    prev = getattr(_ACTIVE, "region", None)
    _ACTIVE.region = region
    try:
        yield region
    finally:
        _ACTIVE.region = prev


def current_region() -> Optional[TrainRegion]:
    """The calling thread's :class:`TrainRegion` (None off the sharded
    steps: single-device training, the serve engine and every other serve
    path)."""
    return getattr(_ACTIVE, "region", None)


def tp_part(kind: str) -> Optional[TrainRegion]:
    """The current region when the products of the layer ``kind`` are
    partitioned over ``tp`` (:func:`tp_whole`), else None."""
    r = current_region()
    return r if r is not None and r.tp_size > 1 and kind not in r.whole \
        else None


#: the layer kind of each leaf the partitioned step may cut over ``tp``;
#: any other leaf (the norms) is replicated
LEAF_KINDS = {
    **dict.fromkeys(("embed", "lm_head", "pos_embed"), "vocab"),
    **dict.fromkeys(("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm",
                     "k_norm"), "attn"),
    **dict.fromkeys(("wi", "wg", "wd"), "mlp"),
    **dict.fromkeys(("router", "shared_gate", "e_wi", "e_wg", "e_wd",
                     "shared_wi", "shared_wg", "shared_wd", "dense_wi",
                     "dense_wg", "dense_wd"), "moe"),
    **dict.fromkeys(("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                     "A_log", "ssm_D", "dt_bias", "ssm_norm", "out_proj"),
                    "mamba"),
    "fused_proj": "fused",
}


def tp_whole(cfg: Any, tp: int) -> Dict[str, str]:
    """The layer kinds of ``cfg`` (the values of :data:`LEAF_KINDS`) that
    run whole on every rank of a ``tp``-way model axis, each with why; the
    others partition. A kind partitions when ``tp`` divides every width
    it cuts, so the rule table's guard keeps ``tp`` on each of its
    leaves:

    * ``vocab`` (the embedding, the head and the loss): the padded
      vocabulary;
    * ``attn``: the query heads, with the GQA groups whole on a rank (the
      KV heads may stay whole: each rank then takes the ones its query
      heads read). Else attention runs whole: its leaves are still stored
      over ``tp``, gathered whole, and every rank forms the same gradient;
    * ``mlp`` (a dense arch's and zamba2's shared block's): its width;
    * ``moe``: the shared experts' and the dense residual's widths, and
      the padded experts ``E`` (split by expert) or else their hidden width
      (split by hidden dim), as the rule table's ``e_wi/e_wg/e_wd`` rules
      choose;
    * ``mamba``: Mamba1's channels ``dI``; Mamba2's ``dI``, its SSD heads
      and its fused ``in_proj`` (``z | x | B | C | dt``) and conv (``x |
      B | C``) widths, each stored in contiguous blocks that the step
      exchanges (:func:`exchange_fused`);
    * ``fused`` (zamba2's shared block input ``concat([x, x0]) @
      fused_proj``): ``d_model``, the product's columns."""
    cuts: Dict[str, Dict[str, int]] = {
        "vocab": {"padded vocabulary": cfg.padded_vocab}}
    if cfg.num_heads:
        cuts["attn"] = {"query heads": cfg.num_heads}
    if cfg.moe:
        m = {}
        if cfg.shared_expert_d_ff:
            m["shared experts' width"] = cfg.shared_expert_d_ff
        if cfg.dense_residual:
            m["dense residual's width"] = cfg.d_ff
        cuts["moe"] = m
    elif cfg.d_ff and (not cfg.ssm or cfg.hybrid_attn_every):
        cuts["mlp"] = {"MLP width": cfg.d_ff}
    if cfg.ssm:
        dI, N = cfg.d_inner, cfg.ssm_state
        cuts["mamba"] = {"Mamba channels": dI}
        if cfg.ssm_version == 2:
            cuts["mamba"].update({
                "SSD heads": cfg.ssm_heads,
                "fused in_proj": 2 * dI + 2 * N + cfg.ssm_heads,
                "fused conv": dI + 2 * N})
    if cfg.hybrid_attn_every:
        cuts["fused"] = {"fused_proj's columns": cfg.d_model}
    out = {}
    for kind, widths in cuts.items():
        for what, n in widths.items():
            if n % tp:
                out[kind] = f"model axis {tp} does not divide the {what} ({n})"
                break
    if cfg.moe and "moe" not in out:
        E = cfg.num_experts + cfg.moe_expert_pad
        if E % tp and cfg.moe_d_ff % tp:
            out["moe"] = (f"model axis {tp} divides neither the {E} experts"
                          f" nor their hidden width ({cfg.moe_d_ff})")
    if "attn" in cuts and "attn" not in out and cfg.num_kv_heads % tp:
        h, g = cfg.num_heads // tp, cfg.num_heads // cfg.num_kv_heads
        if h % g and g % h:
            out["attn"] = (f"model axis {tp} cuts the GQA groups "
                           f"({cfg.num_heads} query heads over "
                           f"{cfg.num_kv_heads} KV heads)")
    return out


def tp_compute_why(cfg: Any, ctx: ShardCtx) -> Optional[str]:
    """None when the sharded step partitions ``cfg``'s products over the
    ctx's ``tp`` axis; else why its step gathers every leaf whole: only
    when no ``model`` axis is above 1. On one, each layer kind partitions
    where ``tp`` divides what it cuts, and the rest run whole on every
    rank (:func:`tp_whole`)."""
    tp = ctx.axis_size("tp") if ctx.mesh is not None and ctx.tp else 1
    return "no model axis above 1" if tp <= 1 else None


def tp_compute(cfg: Any, ctx: ShardCtx) -> bool:
    """True when the sharded step partitions ``cfg``'s products over the
    model axis (:func:`tp_compute_why`)."""
    return tp_compute_why(cfg, ctx) is None


def split_spec(spec: Spec, tp: Sequence[str]) -> Tuple[Spec, Spec]:
    """(the ``tp`` entries of ``spec``, the others), each a spec with None
    in the place of the entries it leaves out."""
    on = tuple(e if set(axes_of(e)) & set(tp) else None for e in spec)
    off = tuple(None if set(axes_of(e)) & set(tp) else e for e in spec)
    return on, off


def fused_parts(cfg: Any, how: str) -> Tuple[Tuple[int, bool], ...]:
    """The ``(width, split)`` parts of a fused Mamba leaf along its fused
    dim, in order (:func:`exchange_fused`): ``xz`` Mamba1's ``in_proj``,
    ``zxbcdt`` Mamba2's, ``xbc`` Mamba2's conv (its weight and its decode
    buffer). Mamba2's ``B`` and ``C`` are whole (``ngroups`` 1: every head
    reads them), the rest split over ``tp``."""
    dI, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"xz": ((dI, True), (dI, True)),
            "zxbcdt": ((dI, True), (dI, True), (N, False), (N, False),
                       (nh, True)),
            "xbc": ((dI, True), (N, False), (N, False))}[how]


def exchange_products(cfg: Any, tokens: int) -> bool:
    """Whether a serve step that runs ``tokens`` token rows on a rank
    exchanges a fused Mamba ``in_proj``'s product (``tokens`` rows of its
    columns) rather than its weight block (``d_model`` rows of them):
    where that moves fewer bytes. A decode step's product is a row a
    sequence; the train step always exchanges the weight, whose gradient
    goes back through the exchange's inverse."""
    return tokens < cfg.d_model


def fused_product(y: torch.Tensor, cfg: Any, how: str) -> torch.Tensor:
    """The product ``y`` (..., columns) of a fused Mamba ``in_proj`` (``how``
    as :func:`fused_parts`) in the layout the partitioned layer computes
    with: ``y`` itself where the weight came exchanged, and where the
    region's ``fused_out`` says the weight is this rank's stored block,
    ``y`` exchanged along its last dim (the same columns as the exchanged
    weight's product: the columns of a product are independent)."""
    part = tp_part("mamba")
    if part is None or not part.fused_out:
        return y
    return exchange_fused(part.group, y, part.tp, y.dim() - 1,
                          fused_parts(cfg, how))


def exchange_fused(group: "MeshGroup", t: torch.Tensor,
                   tp: Sequence[str], dim: int,
                   parts: Sequence[Tuple[int, bool]],
                   inverse: bool = False) -> torch.Tensor:
    """A fused leaf (``parts``: its parts along ``dim`` in order, each
    ``(width, split)``) between its layout as stored, rank r's contiguous
    ``1 / tp`` of the whole leaf, and the one the partitioned layer
    computes with: the concatenation, part by part, of the r-th ``1 /
    tp`` of each split part and the whole of every other part. One
    all-to-all over ``tp``. Mamba1's ``in_proj`` is ``x | z``, two split
    parts; Mamba2's is ``z | x | B | C | dt`` with ``B`` and ``C`` whole
    (every head reads them), its conv ``x | B | C``.

    ``inverse`` brings a gradient of the computed layout back to the
    stored one: each column goes back to the rank that stores it, and a
    whole part's gradients, each rank's covering only its heads, are
    summed there (in rank order)."""
    n = group.mesh.axis_size(tp)
    if n == 1:
        return t
    r = group.mesh.axis_index(tp, group.rank)
    c = sum(w for w, _ in parts) // n          # a rank's stored columns

    def within(j, k):
        """Rank j's columns stored on rank k: ``(lo, hi, at)``, columns
        [lo, hi) of the whole leaf at row ``at`` of j's computed layout."""
        out, lo, at = [], 0, 0
        for w, split in parts:
            a, b = (lo + j * w // n, lo + (j + 1) * w // n) if split \
                else (lo, lo + w)
            a2, b2 = max(a, k * c), min(b, (k + 1) * c)
            if a2 < b2:
                out.append((a2, b2, at + a2 - a))
            at, lo = at + b - a, lo + w
        return out

    x = t.movedim(dim, 0)
    if not inverse:
        pieces = [[x[a - r * c:b - r * c] for a, b, _ in within(j, r)]
                  for j in range(n)]
        recv = [sum(b - a for a, b, _ in within(r, k)) for k in range(n)]
    else:
        pieces = [[x[at:at + b - a] for a, b, at in within(r, k)]
                  for k in range(n)]
        recv = [sum(b - a for a, b, _ in within(j, r)) for j in range(n)]
    send = [sum(p.shape[0] for p in ps) for ps in pieces]
    got = group.all_to_all(torch.cat([p for ps in pieces for p in ps]), tp,
                           send, recv)
    if not inverse:
        return got.movedim(0, dim)
    out = got.new_zeros((c,) + tuple(got.shape[1:]))
    i = 0
    for j in range(n):
        for a, b, _ in within(j, r):
            out[a - r * c:b - r * c] += got[i:i + b - a]
            i += b - a
    return out.movedim(0, dim)


# --------------------------------------------------------------------------- #
# serving: the decode cache's layout on a mesh
# --------------------------------------------------------------------------- #

#: the cache leaves of a KV cache, (L?, B, KV, S, hd): their sequence dim
#: is cut over the mesh (the reference's sequence-parallel cache)
KV_LEAVES = ("k", "v", "shared_k", "shared_v")


def _rows_split(ctx: ShardCtx, batch: int) -> bool:
    """The reference's ``_dim_ok(batch, ctx, "dp")``: the rows go over
    ``dp``."""
    return batch > 1 and batch % ctx.axis_size("dp") == 0


def cache_seq_axes(ctx: ShardCtx, batch: int) -> Tuple[str, ...]:
    """The mesh axes a KV cache's sequence dim is cut over for a batch of
    ``batch`` rows (the reference's ``cache_shardings``): ``sp`` when the
    rows go over ``dp``; else ``(data, model)`` on a mesh of two or more
    axes (B = 1 long contexts, flash-decode style), every ``pod`` rank
    holding the same blocks. () off a mesh."""
    if ctx.mesh is None:
        return ()
    names = ctx.mesh.axis_names
    if _rows_split(ctx, batch) or len(names) < 2:
        return axes_of(ctx.sp)
    return tuple(a for a in ("data", "model") if a in names)


def cache_specs(cfg: Any, ctx: ShardCtx, batch: int,
                cache: Dict[str, Any]) -> Dict[str, Any]:
    """A spec per leaf of a decode cache (``lm.init_cache``'s dict; ``pos``
    None) on ``ctx`` for a batch of ``batch`` rows, the reference's
    ``cache_shardings`` leaf for leaf:

    * ``k``, ``v``, ``shared_k``, ``shared_v`` (L?, B, KV, S, hd): the rows
      over ``dp`` when it divides them, and S over
      :func:`cache_seq_axes`;
    * a conv buffer (..., B, K-1, C): C over ``tp`` where it divides it;
    * a state (..., B, dI, N) or (..., B, nh, hp, N): dI or nh over ``tp``
      where it divides it. Where the rows do not go over ``dp`` the
      reference puts it over ``(data, model)``; here it stays on ``tp``,
      every ``data`` rank holding the same block (the one difference).

    An SSM leaf goes over ``tp`` only where the Mamba layer partitions
    (:func:`tp_whole`), which every registered config's does where ``tp``
    divides the leaf. A Mamba2 conv buffer's block on ``tp`` is in the
    layout the partitioned layer computes with, ``[x_r | B | C]``, not the
    r-th contiguous block of ``[x | B | C]``: its sharding
    (:func:`cache_shardings`) is a :class:`FusedSharding`."""
    if ctx.mesh is None:
        return {k: None for k in cache}
    rows = _rows_split(ctx, batch)
    dp = (ctx.dp if len(ctx.dp) > 1 else ctx.dp[0]) if rows else None
    sp = cache_seq_axes(ctx, batch)
    sp = sp[0] if len(sp) == 1 else (sp or None)
    tpn = ctx.axis_size("tp")
    on_tp = ctx.tp is not None and (tpn == 1 or "mamba" not in
                                    tp_whole(cfg, tpn))

    def tp_if(n: int):
        return ctx.tp if on_tp and n > 1 and n % tpn == 0 else None

    def spec(t: torch.Tensor, kv: bool) -> Spec:
        nd = t.dim()
        if kv:
            return (None,) * (nd - 4) + (dp, None, sp, None)
        if nd >= 2 and t.shape[-2] == cfg.ssm_conv - 1:      # conv buffer
            return (None,) * (nd - 3) + (dp, None, tp_if(t.shape[-1]))
        lead = nd - 3 if nd == 4 else nd - 4     # m1 (B, dI, N), m2 (B, nh,
        return (None,) * lead + (dp, tp_if(t.shape[lead + 1])) \
            + (None,) * (nd - lead - 2)          # hp, N)

    out: Dict[str, Any] = {}
    for k, v in cache.items():
        if k == "pos":
            out[k] = None
        elif isinstance(v, tuple):
            out[k] = tuple(spec(t, False) for t in v)
        else:
            out[k] = spec(v, k in KV_LEAVES)
    return out


def cache_shardings(cfg: Any, ctx: ShardCtx, batch: int,
                    cache: Dict[str, Any]) -> Dict[str, Any]:
    """A sharding per leaf of a decode cache on ``ctx`` for a batch of
    ``batch`` rows (None off a mesh and for ``pos``): a
    :class:`NamedSharding` of :func:`cache_specs`' spec, and for a Mamba2
    conv buffer on ``tp`` a :class:`FusedSharding` (its block is ``[x_r |
    B | C]``). Their :meth:`~NamedSharding.shard` and
    :meth:`~NamedSharding.assemble` give a rank's block of a whole cache
    and the whole from the blocks (:func:`cache_block`,
    :func:`assemble_cache`)."""
    specs = cache_specs(cfg, ctx, batch, cache)
    if ctx.mesh is None:
        return specs

    def sharding(t, spec):
        if cfg.ssm_version == 2 and t.shape[-2] == cfg.ssm_conv - 1 \
                and spec[-1] is not None:
            return FusedSharding(ctx.mesh, spec, fused_parts(cfg, "xbc"))
        return NamedSharding(ctx.mesh, spec)

    out = _per_leaf(lambda k, i, t: sharding(
        t, specs[k] if i is None else specs[k][i]), cache)
    if "pos" in out:
        out["pos"] = None
    return out


def _per_leaf(fn, cache: Dict[str, Any]) -> Dict[str, Any]:
    """``fn(key, i, t)`` of each tensor of a cache (``i`` its index in a
    tuple leaf, else None); ``pos`` is kept."""
    return {k: v if k == "pos" else
            tuple(fn(k, i, t) for i, t in enumerate(v))
            if isinstance(v, tuple) else fn(k, None, v)
            for k, v in cache.items()}


def cache_block(cfg: Any, ctx: ShardCtx, batch: int, cache: Dict[str, Any],
                rank: Optional[int] = None, meta: bool = False
                ) -> Dict[str, Any]:
    """``rank``'s block (default this process's) of a whole decode cache
    under :func:`cache_shardings`, as fresh tensors (``meta``: empty meta
    tensors of the block's shape, for the dry run). ``pos`` is kept."""
    if ctx.mesh is None:
        return dict(cache)
    rank = ctx.rank if rank is None else rank
    shardings = cache_shardings(cfg, ctx, batch, cache)

    def cut(k, i, t):
        t = (shardings[k] if i is None else shardings[k][i]).shard(t, rank)
        if meta:
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t.clone(memory_format=torch.contiguous_format)

    return _per_leaf(cut, cache)


def assemble_cache(shardings: Dict[str, Any],
                   blocks: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The whole cache from every rank's block (``blocks[r]`` rank ``r``'s,
    under ``shardings`` from :func:`cache_shardings`): concatenation, no
    arithmetic. ``pos`` is rank 0's."""
    def join(k, i, _):
        if i is None:
            return shardings[k].assemble([b[k] for b in blocks])
        return shardings[k][i].assemble([b[k][i] for b in blocks])

    return _per_leaf(join, blocks[0])
