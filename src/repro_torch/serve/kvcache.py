"""Paged KV-cache pool for continuous-batching serve (torch port of
``repro.serve.kvcache``).

The decode cache is a *pool* of fixed-size blocks plus per-sequence block
tables. K and V are STACKED along a leading axis of one pool tensor
``(L, 2, N, KV, block, hd)``, so one scatter writes a token's K and V and
one gather reads page pairs.

Two halves:

* :class:`BlockPool` — the HOST-side allocator, copied unchanged from the
  reference (refcounts, the async deferred-free fence, the stalled-row
  reservation floor). Block id 0 is the reserved *sink*: never handed out,
  and the target of every masked or inactive KV write.
* device-side helpers. The reference versions are functional
  (``pool.at[...].set`` returning a new array); here they WRITE IN PLACE
  (``index_put_``) into the one preallocated pool tensor and return it, so
  call sites read the same as the reference's. Masked entries all go to the
  sink block with duplicate indices; on CUDA ``index_put_`` with duplicates
  picks an arbitrary writer, which is fine because the sink's contents are
  garbage by contract (tests comparing pool bytes mask block 0 out).

``copy_blocks`` and ``set_carry_rows`` (prefix cache, async decode) come
with the slices that port those engine paths.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from ..configs.base import ModelConfig

__all__ = ["BlockPool", "init_kv_pool", "scatter_prefill_row",
           "scatter_prefill_rows", "scatter_token_window", "gather_pages",
           "gather_read_attention", "append_kv", "extend_block_tables",
           "set_table_rows", "SINK_BLOCK"]

#: Block id 0 is reserved: never allocated, target of masked-row KV writes.
SINK_BLOCK = 0

_NEG_INF = -2.0 ** 30  # matches models.attention / kernels (bf16-safe)


class BlockPool:
    """Free-list allocator over ``num_blocks`` KV blocks of ``block_size``
    token slots each.

    Invariants (exercised by ``tests/test_kvcache.py`` and
    ``tests/test_prefix_cache.py``):

    * ``num_free + allocated == num_blocks - 1`` (the sink is neither;
      each allocated id counts ONCE however many references hold it);
    * a block id is never handed out twice without its refcount dropping
      to zero through ``free``/``free_deferred`` first;
    * ``free`` of an unallocated (or sink) id raises — including a second
      ``free`` after a shared block's LAST reference already dropped;
    * ``alloc`` is all-or-nothing: it returns ``None`` rather than a partial
      allocation when the pool cannot cover the request (the admission
      back-pressure signal).
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is the sink)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        # LIFO free list: recently freed blocks are re-used first (warm)
        self._free: List[int] = list(range(num_blocks - 1, SINK_BLOCK, -1))
        self._allocated: set = set()
        #: live reference count per allocated block (prefix sharing): the
        #: free paths DECREMENT and only release at zero
        self._refs: dict = {}
        # deferred-free fence (async decode lookahead): blocks whose owner
        # row may still be WRITTEN by an in-flight compiled chunk sit here —
        # still accounted as allocated, invisible to alloc — until the
        # engine advances the fence (see free_deferred / release_deferred)
        self._deferred_young: List[int] = []
        self._deferred_old: List[int] = []
        self._deferred_set: set = set()
        # reservation floor (admit-vs-stalled-row fairness): the engine
        # reserves the unmet block demand of fenced/stalled resident rows;
        # plain alloc (admission) cannot dip below it, while grow calls
        # pass use_reserved=True and drain it oldest-stalled-first
        self._reserved = 0
        self._g_free = self._g_used = self._g_deferred = None
        self._g_shared = None
        self._g_reserved = None

    def set_metrics(self, metrics) -> None:
        """Bind (or unbind with None) a :class:`repro.obs.MetricsRegistry`:
        the pool keeps ``pool.blocks_free`` / ``pool.blocks_used`` /
        ``pool.blocks_deferred`` gauges current at every alloc, free,
        deferred-free and fence advance. Pool mutations are per-block-batch
        (a handful per engine cycle), so three gauge writes are noise."""
        if metrics is None:
            self._g_free = self._g_used = self._g_deferred = None
            self._g_shared = None
            self._g_reserved = None
            return
        self._g_free = metrics.gauge("pool.blocks_free")
        self._g_used = metrics.gauge("pool.blocks_used")
        self._g_deferred = metrics.gauge("pool.blocks_deferred")
        self._g_shared = metrics.gauge("pool.blocks_shared")
        self._g_reserved = metrics.gauge("pool.blocks_reserved")
        with self._lock:
            self._note_locked()

    def _note_locked(self) -> None:
        if self._g_free is not None:
            self._g_free.set(len(self._free))
            self._g_used.set(len(self._allocated))
            self._g_deferred.set(len(self._deferred_young)
                                 + len(self._deferred_old))
            self._g_shared.set(sum(1 for c in self._refs.values() if c > 1))
        if self._g_reserved is not None:
            self._g_reserved.set(self._reserved)

    # ------------------------------------------------------------- accounting
    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_allocated(self) -> int:
        with self._lock:
            return len(self._allocated)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` KV entries."""
        return -(-num_tokens // self.block_size)

    def can_alloc(self, n: int, *, use_reserved: bool = False) -> bool:
        with self._lock:
            return n <= self._avail_locked(use_reserved)

    # ------------------------------------------------- stalled-row reservation
    def set_reserved(self, n: int) -> None:
        """Set the reservation floor: ``n`` free blocks are held back from
        plain :meth:`alloc`/:meth:`grow_table` and only reachable with
        ``use_reserved=True``. The engine sets this to the unmet growth
        demand of stalled resident rows (oldest-stalled-first), so fresh
        admissions cannot indefinitely snipe the blocks a fenced-growth
        row is waiting for. The floor is advisory against what is
        CURRENTLY free — it never blocks frees or fence releases, it just
        earmarks them as they arrive."""
        if n < 0:
            raise ValueError("reservation must be >= 0")
        with self._lock:
            self._reserved = n
            self._note_locked()

    @property
    def reserved(self) -> int:
        with self._lock:
            return self._reserved

    @property
    def num_free_unreserved(self) -> int:
        """Free blocks visible to plain (admission) allocation."""
        with self._lock:
            return self._avail_locked(False)

    def _avail_locked(self, use_reserved: bool) -> int:
        if use_reserved:
            return len(self._free)
        return max(0, len(self._free) - self._reserved)

    # ------------------------------------------------------------- alloc/free
    def alloc(self, n: int, *, use_reserved: bool = False
              ) -> Optional[List[int]]:
        """Take ``n`` blocks at refcount 1, or None (and take nothing) if
        fewer are free. Only the zero-ref transition of ``free`` /
        ``release_deferred`` re-enters the free list, so a block with live
        references can never be handed out here. Plain calls respect the
        stalled-row reservation floor (:meth:`set_reserved`); resident-row
        growth passes ``use_reserved=True`` to drain it."""
        if n < 0:
            raise ValueError("alloc of negative block count")
        with self._lock:
            if n > self._avail_locked(use_reserved):
                return None
            ids = [self._free.pop() for _ in range(n)]
            self._allocated.update(ids)
            for b in ids:
                self._refs[b] = 1
            self._note_locked()
            return ids

    def incref(self, ids: Sequence[int]) -> None:
        """Pin blocks for an additional holder (prefix sharing: a second
        request's table pointing at cached prompt blocks, or the prefix
        index parking a completed request's prefix). Deferred blocks are
        un-pinnable — they are already fenced for release."""
        with self._lock:
            for b in ids:
                if b not in self._allocated or b in self._deferred_set:
                    raise ValueError(
                        f"incref of block {b} that is not live "
                        f"(unallocated, deferred, or the sink)")
                self._refs[b] += 1
            self._note_locked()

    def refcount(self, b: int) -> int:
        """Live references on ``b`` (0 when free/deferred) — the engine's
        copy-on-write trigger: a write into a block with refcount > 1 must
        fork it first."""
        with self._lock:
            return self._refs.get(b, 0)

    @property
    def num_shared(self) -> int:
        """Blocks held by more than one reference."""
        with self._lock:
            return sum(1 for c in self._refs.values() if c > 1)

    def free(self, ids: Sequence[int]) -> None:
        """Drop ONE reference per id; a block returns to the free list only
        when its last reference drops (shared prefix blocks survive their
        co-holders' retirements)."""
        with self._lock:
            for b in ids:
                if b not in self._allocated or b in self._deferred_set:
                    raise ValueError(
                        f"free of block {b} that is not allocated "
                        f"(double free, a deferred block, or the sink)")
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    del self._refs[b]
                    self._allocated.discard(b)
                    self._free.append(b)
            self._note_locked()

    # ------------------------------------------------- deferred-free fence
    def free_deferred(self, ids: Sequence[int]) -> None:
        """Queue blocks for return to the pool behind the async-decode
        FENCE. A preempted row may still be written by the chunk program in
        flight at preemption time (and by a chunked-prefill window enqueued
        the same cycle), so its blocks must not be handed back out until
        that device work has provably retired. Deferred blocks stay
        accounted as allocated (the ``num_free + num_allocated`` invariant
        holds) but are invisible to :meth:`alloc` / :meth:`grow_table`
        until TWO :meth:`release_deferred` calls later.

        Like :meth:`free` this drops ONE reference per id: a SHARED block
        (live refs remain — e.g. a preempted row's prefix blocks still
        held by the prefix index or a co-resident row) is merely
        unpinned, never fenced — the surviving holders' tables still read
        it, and nothing in flight can write a shared prefix block (the
        engine forks before any such write)."""
        with self._lock:
            fenced = []
            for b in ids:
                if b not in self._allocated or b in self._deferred_set:
                    raise ValueError(
                        f"deferred free of block {b} that is not allocated "
                        f"(double free, or the reserved sink)")
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    del self._refs[b]
                    self._deferred_set.add(b)
                    fenced.append(b)
            self._deferred_young.extend(fenced)
            self._note_locked()

    def release_deferred(self) -> int:
        """Advance the fence by one chunk sync: blocks deferred before the
        PREVIOUS advance return to the free list; blocks deferred since then
        age one stage. The engine calls this each time it has synced a
        compiled chunk (every device write enqueued when the blocks were
        deferred precedes the NEXT chunk on the pool's data-dependency
        chain, so two syncs bound all of them). Returns the number of
        blocks released."""
        with self._lock:
            old = self._deferred_old
            self._deferred_old = self._deferred_young
            self._deferred_young = []
            for b in old:
                self._deferred_set.discard(b)
                self._allocated.discard(b)
                self._free.append(b)
            if old:
                self._note_locked()
            return len(old)

    @property
    def num_deferred(self) -> int:
        """Blocks parked behind the deferred-free fence."""
        with self._lock:
            return len(self._deferred_young) + len(self._deferred_old)

    def grow_table(self, blocks: List[int], n: int, *,
                   use_reserved: bool = False) -> Optional[List[int]]:
        """Extend a sequence's existing allocation by ``n`` blocks — the
        mid-decode growth primitive of two-phase admission. All-or-nothing
        like :meth:`alloc`: returns the new ids (also appended to ``blocks``
        in place, keeping the caller's table mirror authoritative) or None
        (taking nothing) when the pool cannot cover the growth — the
        engine's preemption signal. Resident rows grow with
        ``use_reserved=True`` so the stalled-row reservation floor is
        theirs to drain."""
        ids = self.alloc(n, use_reserved=use_reserved)
        if ids is None:
            return None
        blocks.extend(ids)
        return ids

    # ---------------------------------------------------------- fragmentation
    def fragmentation(self) -> float:
        """1 - (longest contiguous free run / free blocks): 0.0 when the
        free ids form one contiguous range, approaching 1.0 as the free set
        shatters. Only genuinely FREE blocks count: deferred (fenced) and
        referenced/parked blocks are excluded — they are neither free nor
        movable. Paged attention reads through the table so this is a
        locality metric, not a correctness one."""
        with self._lock:
            free = sorted(self._free)
        if not free:
            return 0.0
        longest = run = 1
        for a, b in zip(free, free[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(free)

    def defragment(self) -> float:
        """Order the free list so future allocations hand out ascending,
        contiguous-when-possible id runs; returns the fragmentation metric
        after the compaction. Safe while sequences run: allocated blocks are
        never moved (tables keep pointing at the same ids), and blocks with
        live references — shared prefixes, index-parked blocks — or sitting
        behind the deferred-free fence are by invariant not in the free
        list, so the sort cannot disturb them (guarded below: a violation
        means a refcount bug upstream, better loud than silent)."""
        with self._lock:
            bad = [b for b in self._free
                   if b in self._refs or b in self._deferred_set
                   or b == SINK_BLOCK]
            if bad:
                raise RuntimeError(
                    f"free list holds live/deferred/sink blocks {bad}: "
                    "refcount accounting is corrupt")
            self._free.sort(reverse=True)  # LIFO pop() yields ascending ids
        return self.fragmentation()


# ---------------------------------------------------------------- device side
def init_kv_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                 device=None) -> torch.Tensor:
    """Allocate the pooled KV storage: one ``(L, 2, num_blocks, KV, block,
    hd)`` tensor in the compute dtype — axis 1 stacks K (0) and V (1).
    ``device`` None means CUDA."""
    if cfg.ssm or cfg.hybrid_attn_every:
        raise ValueError(
            f"{cfg.name}: paged KV applies to attention caches only "
            "(SSM state is O(1) per sequence)")
    from ..device import resolve_device
    from ..models.layers import dtype_of
    shape = (cfg.num_layers, 2, num_blocks, cfg.num_kv_heads, block_size,
             cfg.hd)
    return torch.zeros(shape, dtype=dtype_of(cfg.compute_dtype),
                       device=resolve_device(device))


def scatter_prefill_row(pool: torch.Tensor, blocks: torch.Tensor,
                        krow: torch.Tensor, vrow: torch.Tensor
                        ) -> torch.Tensor:
    """Write one prefilled sequence into its blocks, in place.

    pool: (L, 2, N, KV, bs, hd); blocks: (nb,) int; krow/vrow:
    (L, KV, S, hd) with ``S <= nb * bs``. Returns the (same) pool.
    """
    return scatter_prefill_rows(pool, blocks[None], krow[:, None],
                                vrow[:, None])


def scatter_prefill_rows(pool: torch.Tensor, blocks: torch.Tensor,
                         krows: torch.Tensor, vrows: torch.Tensor
                         ) -> torch.Tensor:
    """Write a whole admitted GROUP's prefilled K and V in one in-place
    scatter.

    pool: (L, 2, N, KV, bs, hd); blocks: (Bg, nb) int — every row uses the
    same block count (pad rows and a short prompt's tail point at the
    sink); krows/vrows: (L, Bg, KV, S, hd) with ``S <= nb * bs``. Returns
    the (same) pool.
    """
    L, _, _, KV, bs, hd = pool.shape
    Bg, nb = blocks.shape
    rows = torch.stack([krows, vrows], dim=1)     # (L, 2, Bg, KV, S, hd)
    S = rows.shape[4]
    pad = nb * bs - S
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    # (L, 2, Bg, KV, nb*bs, hd) -> (L, 2, Bg, nb, KV, bs, hd): page-major
    paged = rows.reshape(L, 2, Bg, KV, nb, bs, hd).permute(
        0, 1, 2, 4, 3, 5, 6)
    pool[:, :, blocks.long()] = paged.to(pool.dtype)
    return pool


def scatter_token_window(pool_l: torch.Tensor, new_k: torch.Tensor,
                         new_v: torch.Tensor, tables: torch.Tensor,
                         start: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Write a WINDOW of ``C`` consecutive tokens per batch row through the
    block tables, in place — the chunked-prefill scatter.

    pool_l: (2, N, KV, bs, hd) one layer's stacked pages (a view of the
    pool); new_k/new_v: (B, C, KV, hd); tables: (B, max_blocks) int;
    start: (B,) int first write position per row (token ``c`` lands at
    ``start[b] + c``); valid: (B, C) bool — invalid entries go to the sink
    block. Returns the (same) pool_l.
    """
    _, _, _, bs, _ = pool_l.shape
    B, mb = tables.shape
    C = new_k.shape[1]
    pos = start.long()[:, None] + torch.arange(C, device=start.device)
    idx = torch.clamp(pos // bs, 0, mb - 1)
    blk = torch.where(valid, tables.long().gather(1, idx),
                      torch.full_like(idx, SINK_BLOCK))
    off = torch.where(valid, pos % bs, torch.zeros_like(pos))
    new = torch.stack([new_k, new_v], dim=2)          # (B, C, 2, KV, hd)
    # the advanced indices are split by a slice, so (as in numpy and JAX)
    # their broadcast dims (B, C) lead the indexed view: (B, C, 2, KV, hd)
    pool_l[:, blk, :, off] = new.to(pool_l.dtype)
    return pool_l


def extend_block_tables(tables: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, blocks: torch.Tensor
                        ) -> torch.Tensor:
    """Write newly granted block ids into the resident block-table tensor
    at ``(rows[i], cols[i])``, in place. tables: (B, max_blocks) int32;
    rows/cols/blocks: (M,) int."""
    tables[rows.long(), cols.long()] = blocks.to(tables.dtype)
    return tables


def set_table_rows(tables: torch.Tensor, rows: torch.Tensor,
                   new_rows: torch.Tensor) -> torch.Tensor:
    """Replace whole block-table rows in place (admission merge writes a
    sequence's prompt blocks; retirement/preemption zeroes the row).
    tables: (B, mb); rows: (M,) int; new_rows: (M, mb) int."""
    tables[rows.long()] = new_rows.to(tables.dtype)
    return tables


def gather_pages(pool_l: torch.Tensor, tables: torch.Tensor):
    """Gather one layer's K and V pages for a batch of sequences.

    pool_l: (2, N, KV, bs, hd); tables: (B, max_blocks) int. Returns
    ``(ks, vs)``, each (B, KV, max_blocks * bs, hd) with token position
    ``j`` at gathered index ``j`` — the materialized oracle read path.
    """
    B, mb = tables.shape
    _, _, KV, bs, hd = pool_l.shape
    pages = pool_l[:, tables.long()]              # (2, B, mb, KV, bs, hd)
    pages = pages.permute(0, 1, 3, 2, 4, 5).reshape(2, B, KV, mb * bs, hd)
    return pages[0], pages[1]


def gather_read_attention(q: torch.Tensor, pool_l: torch.Tensor,
                          tables: torch.Tensor, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """The reference (oracle) paged read path: gather the fully padded
    span via :func:`gather_pages`, mask by each row's length, softmax.

    q: (B, H, hd); pool_l: (2, N, KV, bs, hd); tables: (B, max_blocks) int;
    lengths: (B,) int per-row position ``pos``. Returns (B, H, hd) in the
    pool dtype. Scores are fp32 from upcast operands (the reference's
    ``preferred_element_type=float32``)."""
    B, H, hd = q.shape
    KV = pool_l.shape[2]
    G = H // KV
    ks, vs = gather_pages(pool_l, tables)         # (B, KV, T, hd)
    T = ks.shape[2]
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg.float(), ks.float()) \
        * (hd ** -0.5)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, :] <= lengths.long()[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(vs.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", probs, vs)
    return out.reshape(B, H, hd)


def append_kv(pool_l: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
              tables: torch.Tensor, pos: torch.Tensor, active: torch.Tensor
              ) -> torch.Tensor:
    """Write one decode step's K AND V for every batch row through the
    block table, in place — one fused scatter.

    pool_l: (2, N, KV, bs, hd); new_k/new_v: (B, KV, hd); tables:
    (B, max_blocks); pos: (B,) int write position per row; active: (B,)
    bool. Inactive rows are redirected to the sink block. Returns the
    (same) pool_l.
    """
    _, _, _, bs, _ = pool_l.shape
    B, mb = tables.shape
    pos = pos.long()
    idx = torch.clamp(pos // bs, 0, mb - 1)
    blk = torch.where(active, tables.long().gather(1, idx[:, None])[:, 0],
                      torch.full_like(idx, SINK_BLOCK))
    off = torch.where(active, pos % bs, torch.zeros_like(pos))
    new = torch.stack([new_k, new_v], dim=1)      # (B, 2, KV, hd)
    pool_l[:, blk, :, off] = new.to(pool_l.dtype)
    return pool_l
