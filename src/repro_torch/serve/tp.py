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
  carry first);
* ``OP_GATHER_PAGES``: the snapshot's pages of the indexed blocks, every
  rank's heads all-gathered in rank order, so rank 0 writes a
  single-device engine's file;
* ``OP_WRITE_PAGES``: restore's page writes; the snapshot's whole pages
  travel in the descriptor as int32 words of their bytes (a descriptor is
  broadcast, so each follower receives every head) and each rank copies
  its own heads into its pool shard;
* ``OP_RESET``: failure isolation's in-place reset of the pool shard (or
  slot state), the device tables and the carry;
* ``OP_CONTIG_PREFILL``, ``OP_CONTIG_DECODE``, ``OP_CONTIG_DROP``: the
  per-call baseline's contiguous prefill and ``n``-step greedy decode,
  each rank's head-sharded contiguous cache kept under the group's key.

The ops of :data:`HOST_ARGS` take the descriptor's host arrays as they
are (their counts set Python loop bounds, which a device copy would have
to read back); every other op gets device copies.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (TPGroup, gather_tp,
                                    shard_serve_params, validate_serve_mesh)
from ..kernels import ops as kernel_ops
from ..models import lm
from .chunk_graph import ChunkProgram
from .kvcache import (copy_blocks, extend_block_tables, init_kv_pool,
                      scatter_prefill_rows, set_carry_rows, set_table_rows)

__all__ = ["serve_follower", "follow_engines", "release_followers",
           "tp_active", "chunk_step", "OPS", "OP_STOP", "OP_EXIT", "OP_INIT", "OP_PREFILL",
           "OP_SCATTER", "OP_TABLE_ROWS", "OP_EXTEND", "OP_COPY",
           "OP_CARRY_ROWS", "OP_CARRY_REM", "OP_CLEAR", "OP_WINDOW",
           "OP_CHUNK", "OP_GATHER_PAGES", "OP_WRITE_PAGES", "OP_RESET",
           "OP_CONTIG_PREFILL", "OP_CONTIG_DECODE", "OP_CONTIG_DROP",
           "OP_NAMES", "HOST_ARGS", "PAGED_IMPL_CODES", "tensors",
           "op_args"]

(OP_STOP, OP_INIT, OP_PREFILL, OP_SCATTER, OP_TABLE_ROWS, OP_EXTEND,
 OP_COPY, OP_CARRY_ROWS, OP_CARRY_REM, OP_CLEAR, OP_WINDOW,
 OP_CHUNK, OP_EXIT, OP_GATHER_PAGES, OP_WRITE_PAGES, OP_RESET,
 OP_CONTIG_PREFILL, OP_CONTIG_DECODE, OP_CONTIG_DROP) = range(19)

#: op names, by id (the collective counters' labels)
OP_NAMES = ("stop", "init", "prefill", "scatter", "table_rows", "extend",
            "copy", "carry_rows", "carry_rem", "clear", "window", "chunk",
            "exit", "gather_pages", "write_pages", "reset",
            "contig_prefill", "contig_decode", "contig_drop")

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


def _group_of(st):
    """(rank, world) of ``st``'s shard: (0, 1) off a group."""
    tp = st._tp
    return (0, 1) if tp is None else (tp.rank, tp.world)


def _op_gather_pages(st, key, ids):
    """The pages of blocks ``ids``, (L, 2, n, KV, bs, hd): each rank's
    (L, 2, n, KV / world, bs, hd) gathered along the head axis in rank
    order (the identity off a group)."""
    return gather_tp(st._pkv.index_select(2, ids.long()).contiguous(), dim=3)


def _op_write_pages(st, key, ids, words):
    """Copy this rank's heads of the pages ``words`` (the whole pages
    (L, 2, n, KV, bs, hd), their bytes as int32 words) into blocks
    ``ids`` of its pool shard, in place."""
    rank, world = _group_of(st)
    pool = st._pkv
    L, two, _, kv, bs, hd = pool.shape
    pages = words.view(pool.dtype).reshape(L, two, ids.numel(), kv * world,
                                           bs, hd)
    pool.index_copy_(2, ids.long(), pages[:, :, :, rank * kv:(rank + 1) * kv])


def _op_reset(st, key):
    """Failure isolation's reset, in place (the captured chunk keeps its
    addresses): zero the pool shard and the device tables (paged) or the
    slot state, and the carry; drop the window-0 caches waiting for a
    scatter and the per-call caches."""
    if st.paged:
        st._pkv.zero_()
        st._tables_dev.zero_()
        st._group_kv.clear()
    else:
        for t in tensors(st._sstate):
            t.zero_()
    st._chunk.carry.zero_()
    st._contig.clear()


def _op_contig_prefill(st, key, toks, max_len):
    """The per-call baseline's prefill of one group (host ``toks`` (B, S),
    ``max_len`` cache positions): its greedy first tokens (B,) int32; the
    contiguous cache and those tokens stay under ``key``."""
    logits, cache = lm.prefill(
        st.cfg, st.params, torch.from_numpy(toks).to(st.device),
        max_len=int(max_len[0]), layers=st._layers)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    st._contig[key] = (cache, cur)
    return cur


def _op_contig_decode(st, key, n):
    """``n[0]`` greedy contiguous decode steps of group ``key`` (eagerly;
    the reference jits them as one scan): its (B, n) int32 tokens."""
    cache, cur = st._contig[key]
    toks = []
    for _ in range(int(n[0])):
        logits, cache = lm.decode_step(st.cfg, st.params, cache, cur,
                                       layers=st._layers)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(cur)
    st._contig[key] = (cache, cur)
    return torch.stack(toks, dim=1)


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
    OP_GATHER_PAGES: _op_gather_pages,
    OP_WRITE_PAGES: _op_write_pages,
    OP_RESET: _op_reset,
    OP_CONTIG_PREFILL: _op_contig_prefill,
    OP_CONTIG_DECODE: _op_contig_decode,
    OP_CONTIG_DROP: lambda st, key: st._contig.pop(key, None),
}

#: ops that take the descriptor's host arrays, not device copies
HOST_ARGS = frozenset({OP_CONTIG_PREFILL, OP_CONTIG_DECODE})


def op_args(op: int, arrays, device) -> list:
    """The arguments op ``op`` takes for the descriptor's ``arrays``:
    the host arrays (:data:`HOST_ARGS`) or their copies on ``device``."""
    if op in HOST_ARGS:
        return list(arrays)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def tensors(tree):
    """Every tensor in a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)


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
        self._tp = tp
        self.device = tp.device
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
        self._contig: Dict[int, tuple] = {}
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
                OPS[op](shard, key, *op_args(op, arrays, tp.device))
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
