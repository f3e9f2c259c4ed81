"""The serve engine's device ops on sharded state, and the follower side
of tensor-parallel serving (``ServeEngine(tp=...)``).

Rank 0 runs the whole engine: scheduler, pipeline, block tables, prefix
cache, sampling. Every device call that touches sharded state (the paged
pool, the device block tables, the decode carry, the window-0 prefill
caches, and every model call, whose all-gathers need every rank) goes
through :meth:`repro_torch.serve.engine.ServeEngine._tp_op`: under the
group's lock it broadcasts a descriptor (an op id from this module, a key
and the op's int32 host arrays) and then runs rank 0's shard of the op.
Followers run :func:`serve_follower`, which receives the descriptors in
the same order and runs the same op on their shard, until rank 0 closes
the engine (:data:`OP_STOP`). Rank 0 samples from gathered logits with a
replicated ``lm_head``, so every rank computes the same tokens; a follower
never reads anything back.

Every op on sharded state is ONE function of :data:`OPS`, ``op(st, key,
*tensors)``, which rank 0 runs on its engine and a follower on its
:class:`_Shard` (the same attribute names), so the ranks run the same
code by construction:

* ``OP_INIT``: a follower allocates the pool shard, the device tables and
  the carry from rank 0's geometry (``ServeEngine.__init__``);
* ``OP_PREFILL``: the window-0 prefill of an admission group, its caches
  kept under the group's key;
* ``OP_SCATTER``: scatter a group's window-0 KV into the pool; keys older
  than the group's are dropped (a group merged without a scatter leaves
  its caches behind);
* ``OP_TABLE_ROWS``, ``OP_EXTEND``, ``OP_COPY``, ``OP_CARRY_ROWS``,
  ``OP_CARRY_REM``, ``OP_CLEAR``: the table, carry and fork writes of the
  merge, growth, copy-on-write guard and retirement;
* ``OP_WINDOW``: one chunked-prefill window;
* ``OP_CHUNK``: one decode chunk, eager under a group
  (``ChunkProgram(graph=False)``; the synchronous engine sends its host
  carry first).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (TPGroup, shard_serve_params,
                                    validate_serve_mesh)
from ..kernels import ops as kernel_ops
from ..models import lm
from .chunk_graph import ChunkProgram
from .kvcache import (copy_blocks, extend_block_tables, init_kv_pool,
                      scatter_prefill_rows, set_carry_rows, set_table_rows)

__all__ = ["serve_follower", "follow_engines", "release_followers",
           "tp_active", "chunk_step", "OPS", "OP_STOP", "OP_EXIT", "OP_INIT", "OP_PREFILL",
           "OP_SCATTER", "OP_TABLE_ROWS", "OP_EXTEND", "OP_COPY",
           "OP_CARRY_ROWS", "OP_CARRY_REM", "OP_CLEAR", "OP_WINDOW",
           "OP_CHUNK", "OP_NAMES", "PAGED_IMPL_CODES"]

(OP_STOP, OP_INIT, OP_PREFILL, OP_SCATTER, OP_TABLE_ROWS, OP_EXTEND,
 OP_COPY, OP_CARRY_ROWS, OP_CARRY_REM, OP_CLEAR, OP_WINDOW,
 OP_CHUNK, OP_EXIT) = range(13)

#: op names, by id (the collective counters' labels)
OP_NAMES = ("stop", "init", "prefill", "scatter", "table_rows", "extend",
            "copy", "carry_rows", "carry_rem", "clear", "window", "chunk",
            "exit")

#: the paged read path, as an int of the OP_INIT descriptor
PAGED_IMPL_CODES = {"kernel": 0, "loop": 1, "gather": 2}


def tp_active(cfg: ModelConfig, tp: TPGroup) -> bool:
    """Whether an engine on ``cfg`` shards over ``tp``: attention archs on
    a group of more than one. SSM and hybrid archs serve on rank 0 alone,
    with the followers idle (the reference replicates them; the outputs
    are the same)."""
    return tp.world > 1 and not (cfg.ssm or cfg.hybrid_attn_every)


def chunk_step(st, carry):
    """The decode chunk's body for :class:`ChunkProgram` on ``st`` (rank
    0's engine or a follower's :class:`_Shard`)."""
    if st.paged:
        return lm.decode_chunk_paged(
            st.cfg, st.params, st._pkv, st._tables_dev, carry,
            st.decode_chunk, impl=st.paged_impl, layers=st._layers)
    return lm.decode_chunk_slots(st.cfg, st.params, st._sstate, carry,
                                 st.decode_chunk, layers=st._layers)


# -- the device ops on sharded state ------------------------------------------
# Each is ``op(st, key, *tensors)``: ``st`` is rank 0's ServeEngine or a
# follower's _Shard (the same attribute names), the tensors are the
# descriptor's arrays on the device. Rank 0 runs them through
# ServeEngine._tp_op, followers through serve_follower: one definition.
def _op_prefill(st, key, toks, lastp):
    """The window-0 prefill of an admission group; its caches wait under
    the group's key for its scatter. Returns the last-position logits."""
    logits, cache = lm.prefill(st.cfg, st.params, toks,
                               max_len=toks.shape[1], last_positions=lastp,
                               layers=st._layers)
    st._group_kv[key] = (cache["k"], cache["v"])
    return logits


def _op_scatter(st, key, blocks2d):
    """Scatter a group's window-0 KV into the pool; caches of older groups
    (merged without a scatter, or dropped) go with it."""
    ck, cv = st._group_kv.pop(key)
    for k in [k for k in st._group_kv if k < key]:
        del st._group_kv[k]
    scatter_prefill_rows(st._pkv, blocks2d, ck, cv)


def _op_carry_rows(st, key, packed):
    c = st._chunk.carry
    set_carry_rows(c[0], c[1], c[2], packed[0], packed[1], packed[2],
                   packed[3])


def _op_carry_rem(st, key, packed):
    st._chunk.carry[2][packed[0].long()] = packed[1]


def _op_clear(st, key, rows):
    """Zero vacated seats' block-table rows (paged) and, async, their
    carry rows. (``t[r] = 0`` would copy the 0 to the device from
    pageable memory, a stream sync; ``index_fill_`` passes it to the
    kernel.)"""
    r = rows.long()
    if st.paged:
        st._tables_dev.index_fill_(0, r, 0)
    if st.async_decode:
        st._chunk.carry.index_fill_(1, r, 0)


def _op_window(st, key, toks, start, valid, last_idx):
    """One chunked-prefill window into the pool; returns its first
    tokens."""
    first, _ = lm.prefill_window_paged(
        st.cfg, st.params, st._pkv, st._tables_dev, toks, start,
        valid.bool(), last_idx, layers=st._layers)
    return first


def _op_chunk(st, key, *carry):
    """One decode chunk (the synchronous engine sends its host carry)."""
    if carry:
        st._chunk.carry.copy_(carry[0])
    st._chunk.run()


OPS = {
    OP_PREFILL: _op_prefill,
    OP_SCATTER: _op_scatter,
    OP_TABLE_ROWS: lambda st, key, rows, tabs:
        set_table_rows(st._tables_dev, rows, tabs),
    OP_EXTEND: lambda st, key, rows, cols, ids:
        extend_block_tables(st._tables_dev, rows, cols, ids),
    OP_COPY: lambda st, key, src, dst: copy_blocks(st._pkv, src, dst),
    OP_CARRY_ROWS: _op_carry_rows,
    OP_CARRY_REM: _op_carry_rem,
    OP_CLEAR: _op_clear,
    OP_WINDOW: _op_window,
    OP_CHUNK: _op_chunk,
}


class _Shard:
    """A follower's device state: the tensors rank 0's engine holds, on
    this rank's shard, under the engine's attribute names (the ops of
    :data:`OPS` read either)."""

    paged = True

    def __init__(self, cfg: ModelConfig, params, tp: TPGroup,
                 geometry: np.ndarray) -> None:
        B, kv_blocks, block_size, mb, n, async_decode, impl = \
            (int(v) for v in geometry)
        self.cfg = cfg
        self.params = params
        self._layers = lm.layer_views(params)
        self.decode_chunk = n
        self.async_decode = bool(async_decode)
        self.paged_impl = {v: k for k, v in PAGED_IMPL_CODES.items()}[impl]
        dev = tp.device
        self._pkv = init_kv_pool(cfg, kv_blocks, block_size, dev,
                                 kv_heads=cfg.num_kv_heads // tp.world)
        self._tables_dev = torch.zeros((B, mb), dtype=torch.int32,
                                       device=dev)
        self._group_kv: Dict[int, tuple] = {}
        self._chunk = ChunkProgram(lambda carry: chunk_step(self, carry),
                                   lambda: (), B, n, dev, graph=False)


def serve_follower(cfg: ModelConfig, params, tp: TPGroup
                   ) -> Optional[Dict[str, Any]]:
    """Run one engine's ops on this rank's shard until rank 0 closes it.

    ``params``: the full weights (this rank cuts its shard, as rank 0's
    engine does), on ``tp.device``. Returns ``{"ops": n, "pool_bytes":
    bytes of this rank's pool shard, "launches": kernel launches from
    OP_INIT to OP_STOP, by kernel}``; returns at once, with no op, for
    an arch that does not shard (:func:`tp_active`), and None when rank 0
    releases the followers (:func:`release_followers`) instead of starting
    an engine. Raises on a descriptor out of order; an exception in an op
    propagates (the caller prints it and exits non-zero, and rank 0's next
    collective fails)."""
    if not tp_active(cfg, tp):
        return {"ops": 0, "pool_bytes": 0, "launches": {}}
    if tp.rank == 0:
        raise ValueError("serve_follower runs on ranks 1..world-1; rank 0 "
                         "runs the ServeEngine")
    validate_serve_mesh(cfg, tp.world)
    shard_params = shard_serve_params(cfg, params, tp.rank, tp.world)
    op, _, arrays = tp.recv()
    if op == OP_EXIT:
        return None
    if op != OP_INIT:
        raise RuntimeError(f"serve follower: first op {op}, expected "
                           "OP_INIT")
    before = kernel_ops.launch_counts()
    n_ops = 1
    ctx = torch.cuda.device(tp.device) if tp.device.type == "cuda" \
        else contextlib.nullcontext()
    with torch.inference_mode(), ctx:
        shard = _Shard(cfg, shard_params, tp, arrays[0])
        while True:
            op, key, arrays = tp.recv()
            n_ops += 1
            if op == OP_STOP:
                break
            if op not in OPS:
                raise RuntimeError(f"serve follower: unknown op {op}")
            with tp.active(OP_NAMES[op]):
                OPS[op](shard, key, *[torch.from_numpy(a).to(tp.device)
                                      for a in arrays])
    after = kernel_ops.launch_counts()
    return {"ops": n_ops,
            "pool_bytes": shard._pkv.numel() * shard._pkv.element_size(),
            "launches": {k: after[k] - before[k] for k in after}}


def follow_engines(cfg: ModelConfig, params, tp: TPGroup) -> list:
    """:func:`serve_follower` for each engine rank 0 builds on ``cfg``, in
    turn, until it releases the followers; their results."""
    out = []
    while True:
        r = serve_follower(cfg, params, tp)
        if r is None:
            return out
        out.append(r)
        if not tp_active(cfg, tp):
            return out


def release_followers(tp: TPGroup) -> None:
    """Rank 0, with no engine open: end the followers'
    :func:`follow_engines`."""
    with tp.lock:
        tp.send(OP_EXIT, 0, ())
