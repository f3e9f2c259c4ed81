"""Elastic scaling: reshard a training state onto another mesh (torch port
of ``repro.train.elastic``).

Checkpoints store whole (gathered) leaves, so changing the number of ranks
between runs is a placement problem: build the shardings for the NEW
:class:`repro_torch.distributed.sharding.ShardCtx` and keep, on each rank,
its block of every leaf. Used by the trainer on init and restore, and
tested across 1 <-> 2 <-> 4 ranks.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx
from ..tree import tree_map
from .train_step import opt_shardings, param_shardings

__all__ = ["reshard_state", "place"]


def place(tree: Any, shardings: Any, rank: int, device=None) -> Any:
    """Each leaf's block for ``rank`` (the leaf itself where its sharding
    is None), as a new contiguous tensor on ``device`` (None: the leaf's),
    so a full leaf is freed once its caller drops it."""
    def put(x: torch.Tensor, sh) -> torch.Tensor:
        block = x if sh is None else sh.shard(x, rank)
        return block.clone(memory_format=torch.contiguous_format).to(
            x.device if device is None else device)
    return tree_map(put, tree, shardings)


def reshard_state(cfg: ModelConfig, state: Any, ctx: ShardCtx,
                  rank: Optional[int] = None, device=None) -> Any:
    """state: ``{"params": ..., "opt": ...}`` of full leaves -> the same
    tree with this rank's blocks under ``ctx`` (``rank``: default the ctx's;
    ``device``: default the ctx's group's, else each leaf's). ``opt`` may
    hold ``m``, ``v``, ``count`` and compression's ``err`` (sharded like
    the params)."""
    pshard = param_shardings(cfg, ctx)
    oshard = dict(opt_shardings(cfg, ctx, pshard), err=pshard)
    rank = ctx.rank if rank is None else rank
    if device is None and ctx.group is not None:
        device = ctx.group.device
    out = dict(state)
    out["params"] = place(state["params"], pshard, rank, device)
    if "opt" in state:
        out["opt"] = place(state["opt"],
                           {k: oshard[k] for k in state["opt"]}, rank,
                           device)
    return out
