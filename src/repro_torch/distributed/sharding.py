"""Tensor-parallel serving rules over ``torch.distributed``.

The port of the serving half of ``repro.distributed.sharding``
(``MeshDivisibilityError``, ``serve_attn_sharded``, ``serve_mlp_sharded``,
``validate_serve_mesh``, ``serve_param_specs``, ``serve_pool_spec``,
``gather_tp``), kept free of JAX. The reference shards with a device mesh
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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["MeshDivisibilityError", "serve_attn_sharded",
           "serve_mlp_sharded", "validate_serve_mesh", "shard_serve_params",
           "TPGroup", "gather_tp", "SERVE_ATTN_LEAVES", "SERVE_MLP_LEAVES"]


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
