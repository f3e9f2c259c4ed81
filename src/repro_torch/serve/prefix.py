"""Prefix cache: a hash trie over block-aligned prompt chunks.

At production scale most traffic shares long system/few-shot prompt
prefixes; re-prefilling them on every admission wastes the hottest device
path AND duplicates their KV in the paged pool. This module is the host
side of copy-on-write KV block sharing:

* prompts are hashed in ``block_size``-token CHUNKS, each chunk keyed on
  ``(parent chain hash, chunk tokens)`` — a trie whose nodes map one full
  prompt chunk to the pool block already holding its KV. Chained hashing
  means a node can only match when its ENTIRE token prefix matches; hash
  collisions are disambiguated by comparing the stored chunk tokens
  (``tests/test_prefix_cache.py`` forces collisions through an injected
  hash function).
* :meth:`PrefixCache.match_and_pin` walks the longest cached prefix for an
  admitted prompt and pins every matched block
  (:meth:`repro_torch.serve.kvcache.BlockPool.incref`) so the admitting row can
  seed its block table with SHARED blocks and budget only its suffix.
  Beyond the last full-chunk match it also offers the best PARTIAL tail
  match — a cached block whose leading tokens extend the match — which the
  engine consumes by copy-on-write fork (clone then continue writing).
* :meth:`PrefixCache.register` inserts a freshly prefilled row's full
  prompt chunks, taking one index reference per block. When the owning
  request later retires and drops its own reference, the block is PARKED:
  alive, invisible to allocation, free to be shared by future admissions.
* :meth:`PrefixCache.evict` is reuse-aware back-pressure: under pool
  pressure the engine releases cold parked blocks by a reuse score
  (hit count x recency) LEAF-FIRST, so a parent chunk is never evicted
  while a cached child still chains through it (the
  parent-before-child trie invariant) — and hot shared prefixes outlive
  cold tails, which is the whole point (arXiv:1502.07451's cost-model
  thesis: victim selection must weigh reuse value, not just age).

The cache never touches device memory itself: it is pure host bookkeeping
over block IDS, thread-safe (admit-stage lookup/evict vs decode-stage
register), with the pool's refcounts as the single source of liveness
truth. A matched prefix is bit-identical KV by construction: chunk KV
depends only on the token prefix and absolute positions, both of which the
chained hash + token comparison pin exactly.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixCache", "PrefixHit"]


def _default_hash(parent_key: int, chunk: bytes) -> int:
    """Chunk-hash chained on the parent chain hash. STABLE content hash
    (blake2b over the parent key + token bytes), not Python's ``hash()``:
    chunk identity must survive ``PYTHONHASHSEED`` changes and process
    restarts so a persisted/cross-process prefix index keys the same
    prompt to the same chain (the cross-tier pinning prerequisite).
    Collisions are still disambiguated by token comparison downstream."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_key.to_bytes(8, "little", signed=True))
    h.update(chunk)
    return int.from_bytes(h.digest(), "little", signed=True)


class _Node:
    """One cached prompt chunk: ``block`` holds the KV of ``tokens`` at
    absolute positions ``[depth*bs, (depth+1)*bs)`` given the parent
    chain's token prefix."""

    __slots__ = ("key", "parent", "children", "block", "tokens", "hits",
                 "last_used", "depth", "warm")

    def __init__(self, key: int, parent: Optional["_Node"], block: int,
                 tokens: np.ndarray, depth: int, now: float,
                 warm: bool = False) -> None:
        self.key = key
        self.parent = parent
        # hash -> list of nodes (collision chain, disambiguated by tokens)
        self.children: Dict[int, List["_Node"]] = {}
        self.block = block
        self.tokens = tokens
        self.hits = 0
        self.last_used = now
        self.depth = depth
        self.warm = warm        # restored from a snapshot, not prefilled here


class PrefixHit:
    """Result of :meth:`PrefixCache.match_and_pin`: ``blocks`` are the
    pinned FULL shared prefix blocks (one per cached chunk, table-order),
    ``tokens`` the total cached token count (``partial_len`` of which sit
    in ``partial_block`` — a pinned shared block the engine must
    copy-on-write fork before writing the row's own suffix into it)."""

    __slots__ = ("blocks", "tokens", "partial_block", "partial_len")

    def __init__(self, blocks: List[int], tokens: int,
                 partial_block: Optional[int], partial_len: int) -> None:
        self.blocks = blocks
        self.tokens = tokens
        self.partial_block = partial_block
        self.partial_len = partial_len


class PrefixCache:
    """Block-granular prompt prefix index over a :class:`BlockPool`.

    ``hash_fn(parent_key, chunk_bytes) -> int`` is injectable so tests can
    force collisions; the default chains Python's bytes hash.
    """

    def __init__(self, pool, hash_fn: Optional[Callable[[int, bytes], int]]
                 = None) -> None:
        self._pool = pool
        self._bs = pool.block_size
        self._hash = hash_fn or _default_hash
        self._lock = threading.Lock()
        self._root: Dict[int, List[_Node]] = {}   # depth-0 collision chains
        self._nodes = 0
        self.stats = {"hits": 0, "misses": 0, "evicted": 0, "warm_hits": 0}
        self._c_hits = self._c_misses = self._c_evicted = None
        self._c_warm = None
        self._g_parked = None

    # ---------------------------------------------------------- observability
    def set_metrics(self, metrics) -> None:
        """Bind (or unbind with None) a metrics registry: ``prefix.hits`` /
        ``prefix.misses`` / ``prefix.evicted`` counters plus the
        ``pool.blocks_parked`` gauge (blocks whose ONLY reference is this
        index — cached capacity reclaimable without touching any row)."""
        if metrics is None:
            self._c_hits = self._c_misses = self._c_evicted = None
            self._c_warm = None
            self._g_parked = None
            return
        self._c_hits = metrics.counter("prefix.hits")
        self._c_misses = metrics.counter("prefix.misses")
        self._c_evicted = metrics.counter("prefix.evicted")
        self._c_warm = metrics.counter("prefix.warm_hits")
        self._g_parked = metrics.gauge("pool.blocks_parked")
        with self._lock:
            self._note_parked_locked()

    def _iter_nodes_locked(self):
        stack = [n for chain in self._root.values() for n in chain]
        while stack:
            node = stack.pop()
            yield node
            for chain in node.children.values():
                stack.extend(chain)

    def _note_parked_locked(self) -> None:
        if self._g_parked is not None:
            self._g_parked.set(sum(
                1 for n in self._iter_nodes_locked()
                if self._pool.refcount(n.block) == 1))

    # -------------------------------------------------------------- accounting
    @property
    def num_nodes(self) -> int:
        with self._lock:
            return self._nodes

    @property
    def num_parked(self) -> int:
        """Cached blocks held ONLY by this index — evictable on pressure
        without touching any resident row."""
        with self._lock:
            return sum(1 for n in self._iter_nodes_locked()
                       if self._pool.refcount(n.block) == 1)

    # ------------------------------------------------------------------ lookup
    def _walk_locked(self, prompt: np.ndarray
                     ) -> Tuple[List[_Node], Optional[_Node], int]:
        """Longest cached prefix of ``prompt``: the matched full-chunk node
        chain, plus the best PARTIAL tail child (a node whose leading
        ``partial_len`` tokens extend the match). The total cached token
        count is capped at ``len(prompt) - 1`` — at least one prompt token
        must be computed so its logits can seed the first output token."""
        bs = self._bs
        chain: List[_Node] = []
        children, parent_key = self._root, 0
        limit = len(prompt) - 1            # leave >= 1 token to compute
        while (len(chain) + 1) * bs <= limit:
            lo = len(chain) * bs
            chunk = prompt[lo:lo + bs]
            h = self._hash(parent_key, chunk.tobytes())
            node = None
            for cand in children.get(h, ()):
                if np.array_equal(cand.tokens, chunk):  # collision guard
                    node = cand
                    break
            if node is None:
                break
            chain.append(node)
            children, parent_key = node.children, node.key
        # partial tail: the best child whose leading tokens extend the match
        lo = len(chain) * bs
        best, best_len = None, 0
        tail = prompt[lo:limit]
        if len(tail) > 0:
            for cands in children.values():
                for cand in cands:
                    m = int(min(len(tail), len(cand.tokens)))
                    eq = np.flatnonzero(cand.tokens[:m] != tail[:m])
                    k = m if eq.size == 0 else int(eq[0])
                    if k > best_len:
                        best, best_len = cand, k
        return chain, best, best_len

    def peek(self, prompt: np.ndarray) -> int:
        """Cached token count for ``prompt`` WITHOUT pinning — the
        admission budgeter (suffix blocks only = ``blocks_for(prompt_len)
        - len(full chain)``). Registration can only grow the match between
        peek and pin, so the budget is conservative."""
        with self._lock:
            chain, _, partial_len = self._walk_locked(np.asarray(prompt))
            return len(chain) * self._bs + partial_len

    def match_and_pin(self, prompt: np.ndarray) -> PrefixHit:
        """Longest-prefix match that PINS every matched block (full chain
        + partial tail) against eviction and release, and bumps the
        chain's reuse statistics. The caller owns one reference per
        returned block: table-seeded full blocks release through the row's
        normal retirement/preemption ``free``; the partial block must be
        released right after its copy-on-write fork."""
        prompt = np.asarray(prompt)
        now = time.perf_counter()
        with self._lock:
            chain, partial, partial_len = self._walk_locked(prompt)
            blocks = [n.block for n in chain]
            for n in chain:
                n.hits += 1
                n.last_used = now
            if partial is not None and partial_len > 0:
                partial.hits += 1
                partial.last_used = now
                self._pool.incref([partial.block])
            else:
                partial, partial_len = None, 0
            if blocks:
                self._pool.incref(blocks)
            hit = bool(blocks) or partial is not None
            self.stats["hits" if hit else "misses"] += 1
            c = self._c_hits if hit else self._c_misses
            if c is not None:
                c.inc()
            if hit and (any(n.warm for n in chain)
                        or (partial is not None and partial.warm)):
                # the match was served (at least partly) by chunks restored
                # from a snapshot — warm start paid off on a live request
                self.stats["warm_hits"] += 1
                if self._c_warm is not None:
                    self._c_warm.inc()
            self._note_parked_locked()
            return PrefixHit(blocks, len(blocks) * self._bs + partial_len,
                             partial.block if partial else None, partial_len)

    def unpin(self, blocks: Sequence[int]) -> None:
        """Release pins taken by :meth:`match_and_pin` (admission unwound,
        or a partial block's fork completed)."""
        if blocks:
            self._pool.free(list(blocks))
            with self._lock:
                self._note_parked_locked()

    # ---------------------------------------------------------------- register
    def register(self, prompt: np.ndarray, blocks: Sequence[int]) -> int:
        """Index a freshly prefilled row's FULL prompt chunks: chunk ``i``
        lives in ``blocks[i]``. Each newly created node takes one index
        reference on its block, so the block survives its owner's
        retirement (parked) and later admissions can share it. Chunks whose
        node already exists are skipped — the canonical block stays, the
        row's duplicate simply retires with the row. Only FULL blocks are
        registerable (a partial block is still written by its owner; a full
        prompt block never is — decode writes land strictly past the
        prompt). Returns the number of nodes created."""
        prompt = np.asarray(prompt)
        bs = self._bs
        now = time.perf_counter()
        created = 0
        with self._lock:
            children, parent_key, parent = self._root, 0, None
            for i in range(len(prompt) // bs):
                chunk = prompt[i * bs:(i + 1) * bs]
                h = self._hash(parent_key, chunk.tobytes())
                node = None
                for cand in children.get(h, ()):
                    if np.array_equal(cand.tokens, chunk):
                        node = cand
                        break
                if node is None:
                    b = int(blocks[i])
                    if self._pool.refcount(b) < 1:
                        break              # owner raced a free: stop here
                    self._pool.incref([b])
                    node = _Node(self._hash(parent_key, chunk.tobytes()),
                                 parent, b, np.array(chunk), i, now)
                    node.key = h
                    children.setdefault(h, []).append(node)
                    self._nodes += 1
                    created += 1
                children, parent_key, parent = node.children, node.key, node
            if created:
                self._note_parked_locked()
        return created

    # ----------------------------------------------------------------- evict
    def evict(self, need: int) -> int:
        """Release up to ``need`` PARKED blocks (refcount 1 — held only by
        this index) back to the pool, coldest-first by reuse score
        ``hits x recency`` and strictly LEAF-FIRST: a node with cached
        children is not a candidate until its subtree is gone, so every
        surviving node's parent chain stays intact (longest-match never
        dangles). Pinned chains (any row holding a reference) are
        untouchable. Returns the number of blocks actually freed."""
        if need <= 0:
            return 0
        now = time.perf_counter()
        freed = 0
        with self._lock:
            while freed < need:
                leaves = [n for n in self._iter_nodes_locked()
                          if not any(n.children.values())
                          and self._pool.refcount(n.block) == 1]
                if not leaves:
                    break
                # reuse score: hit count x recency decay — evict the
                # coldest (low hits, long idle) first
                leaves.sort(key=lambda n: (1 + n.hits)
                            / (1.0 + now - n.last_used))
                take = leaves[:need - freed]
                for n in take:
                    self._remove_locked(n)
                    self._pool.free([n.block])
                    freed += 1
                    self.stats["evicted"] += 1
                    if self._c_evicted is not None:
                        self._c_evicted.inc()
            if freed:
                self._note_parked_locked()
        return freed

    def clear(self) -> int:
        """Drop the ENTIRE index: release every index-held reference and
        reset the trie. The failure-isolation path uses this — after a
        raising model step the pool's KV contents are reinitialized, so
        every cached chunk is stale garbage and must not match future
        admissions. Pinned blocks (rows still referencing them) merely
        lose the index reference; parked blocks return to the pool.
        Returns the number of nodes dropped."""
        with self._lock:
            nodes = list(self._iter_nodes_locked())
            for n in nodes:
                self._pool.free([n.block])
            self._root.clear()
            self._nodes = 0
            self._note_parked_locked()
        return len(nodes)

    # ------------------------------------------------------- persistence
    def export_nodes(self) -> List[Dict]:
        """Serialize the trie for a snapshot: a list of per-node dicts in
        parent-before-child (BFS) order, each carrying its parent's LIST
        INDEX (``-1`` for depth-0 nodes), the chained chunk key, the chunk
        tokens, the reuse hit count, and the pool block id whose KV page
        the snapshot writer must capture. Chained keys are stable blake2b
        content hashes, so the same entries re-key identically in a fresh
        process."""
        with self._lock:
            order: List[_Node] = []
            index: Dict[int, int] = {}
            queue = [n for chain in self._root.values() for n in chain]
            while queue:
                nxt: List[_Node] = []
                for n in queue:
                    index[id(n)] = len(order)
                    order.append(n)
                    for chain in n.children.values():
                        nxt.extend(chain)
                queue = nxt
            return [{"parent": -1 if n.parent is None
                     else index[id(n.parent)],
                     "key": int(n.key), "depth": int(n.depth),
                     "hits": int(n.hits), "tokens": np.array(n.tokens),
                     "block": int(n.block)} for n in order]

    def import_nodes(self, entries: Sequence[Dict],
                     blocks: Sequence[int]) -> int:
        """Rebuild trie nodes from :meth:`export_nodes` entries into an
        EMPTY index, adopting ``blocks[i]`` (freshly allocated by the
        restore path, refcount 1) as node *i*'s index reference — the
        block is born PARKED. Entries must be parent-before-child;
        entries whose parent was dropped (restore truncated to fit the
        pool) are skipped, keeping the parent-chain invariant. Restored
        nodes are flagged ``warm`` so their first live match counts into
        ``prefix.warm_hits``. Returns the number of nodes created."""
        now = time.perf_counter()
        created = 0
        with self._lock:
            nodes: Dict[int, _Node] = {}
            for i, e in enumerate(entries):
                if i >= len(blocks):
                    break
                parent = None
                if e["parent"] >= 0:
                    parent = nodes.get(e["parent"])
                    if parent is None:
                        continue            # parent dropped: skip subtree
                node = _Node(int(e["key"]), parent, int(blocks[i]),
                             np.array(e["tokens"]), int(e["depth"]), now,
                             warm=True)
                node.hits = int(e.get("hits", 0))
                siblings = (self._root if parent is None
                            else parent.children)
                siblings.setdefault(node.key, []).append(node)
                nodes[i] = node
                self._nodes += 1
                created += 1
            self._note_parked_locked()
        return created

    def _remove_locked(self, node: _Node) -> None:
        siblings = (self._root if node.parent is None
                    else node.parent.children)
        chain = siblings.get(node.key, [])
        if node in chain:
            chain.remove(node)
            if not chain:
                del siblings[node.key]
            self._nodes -= 1

    def check_parent_invariant(self) -> bool:
        """Every node's parent is still indexed (test hook): eviction must
        never orphan a child chain."""
        with self._lock:
            for n in self._iter_nodes_locked():
                p = n.parent
                if p is not None and n not in p.children.get(n.key, []):
                    return False
                if p is not None:
                    sibs = (self._root if p.parent is None
                            else p.parent.children)
                    if p not in sibs.get(p.key, []):
                        return False
            return True
