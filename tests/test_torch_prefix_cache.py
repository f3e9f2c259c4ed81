"""The port's prefix cache against the reference's.

Two layers, as in ``tests/test_prefix_cache.py``:

* the trie: each scenario runs one call sequence through
  ``repro.serve.prefix``/``repro.serve.kvcache.BlockPool`` and through the
  port's copies, and the two logs (match results, refcounts, parked and
  node counts, eviction order, metrics, ``warm_hits`` included) must be
  equal; two of them diff the snapshot path's ``export_nodes`` and
  ``import_nodes`` (BFS order, parent indices, a truncated restore) and the
  restored nodes' ``warm`` flag;
* the engine at float32 compute on the stablelm smoke config: with
  ``prefix_cache=True`` the port's sync engine on the CPU and the JAX
  engine on its ``gather`` oracle serve the same call sequences and must
  emit IDENTICAL greedy tokens and equal ``prefix_hits``,
  ``prefix_tokens_saved`` and ``cow_forks``: a batch behind a registered
  chain, a partial-tail copy-on-write fork whose first window starts
  mid-block (at 44 and at 43), and ``_cow_guard`` forking a block pinned
  from outside. Under preemption while a block is shared, which requests
  are preempted and re-admitted depends on thread timing in both engines,
  so that scenario holds the tokens equal and each engine to exact
  invariants (every admission is a first one or follows a preemption, and
  every block comes back once the trie is evicted).

The JAX engine's results are built once per scenario.
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro import obs as jobs
from repro.models import lm as jlm
from repro.serve import kvcache as jkv
from repro.serve import prefix as jprefix
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.params import from_reference
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import prefix as tprefix
from repro_torch.serve.engine import ServeEngine

SIDES = {"jax": (jkv.BlockPool, jprefix.PrefixCache, jobs.MetricsRegistry),
         "torch": (tkv.BlockPool, tprefix.PrefixCache, tobs.MetricsRegistry)}


def _tok(*vals):
    return np.asarray(vals, np.int32)


def _hit(h):
    return (list(h.blocks), h.tokens, h.partial_block, h.partial_len)


# ============================================================ trie layer
def _register_then_match(Pool, Cache, Reg):
    pool = Pool(16, 4)
    prompt = np.arange(1, 13, dtype=np.int32)        # 12 tokens = 3 chunks
    blocks = pool.alloc(3)
    px = Cache(pool)
    log = [px.register(prompt, blocks), px.num_nodes]
    pool.free(blocks)                                # owner retires: parked
    log += [px.num_parked, pool.num_free]
    longer = np.concatenate([prompt, _tok(99, 98)])
    log.append(px.peek(longer))
    hit = px.match_and_pin(longer)
    log += [_hit(hit), [pool.refcount(b) for b in blocks]]
    px.unpin(hit.blocks)
    div = np.concatenate([prompt[:8], _tok(77, 77, 77, 77, 77)])
    log += [px.peek(div), px.stats]
    return log


def _cap_at_prompt_len_minus_one(Pool, Cache, Reg):
    pool = Pool(16, 4)
    prompt = np.arange(1, 9, dtype=np.int32)
    blocks = pool.alloc(2)
    px = Cache(pool)
    px.register(prompt, blocks)
    pool.free(blocks)
    hit = px.match_and_pin(prompt)                   # the same prompt again
    log = [_hit(hit), pool.refcount(blocks[1])]
    px.unpin(hit.blocks + [hit.partial_block])
    return log + [px.num_parked]


def _partial_tail_best_divergence(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    a = np.concatenate([_tok(1, 2, 3, 4), _tok(5, 6, 7, 8)])
    b = np.concatenate([_tok(1, 2, 3, 4), _tok(5, 9, 9, 9)])
    ba, bb = pool.alloc(2), pool.alloc(2)
    px.register(a, ba)
    px.register(b, bb)
    probe = np.concatenate([_tok(1, 2, 3, 4), _tok(5, 6, 7, 0), _tok(0)])
    hit = px.match_and_pin(probe)
    log = [px.num_nodes, _hit(hit)]
    px.unpin(hit.blocks + [hit.partial_block])
    pool.free(ba)
    pool.free(bb)
    return log + [px.num_parked, pool.num_free]


def _hash_collisions(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool, hash_fn=lambda parent, chunk: 7)
    a = np.arange(1, 9, dtype=np.int32)
    b = np.arange(51, 59, dtype=np.int32)
    ba, bb = pool.alloc(2), pool.alloc(2)
    px.register(a, ba)
    px.register(b, bb)
    ha = px.match_and_pin(np.concatenate([a, _tok(99)]))
    hb = px.match_and_pin(np.concatenate([b, _tok(99)]))
    return [px.num_nodes, _hit(ha), _hit(hb), ba, bb]


def _register_skips_existing(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    prompt = np.arange(1, 9, dtype=np.int32)
    first, second = pool.alloc(2), pool.alloc(2)
    log = [px.register(prompt, first), px.register(prompt, second),
           px.num_nodes]
    pool.free(first)
    pool.free(second)
    return log + [px.num_parked, pool.num_free]


def _evict_leaf_first(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    prompt = np.arange(1, 17, dtype=np.int32)        # 4-chunk chain
    blocks = pool.alloc(4)
    px.register(prompt, blocks)
    pool.free(blocks)
    log = [px.evict(1), px.num_nodes, px.check_parent_invariant(),
           px.peek(prompt), sorted(pool._free)]
    log += [px.evict(10), px.num_nodes, pool.num_free, px.stats]
    return log


def _evict_reuse_score(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    hot = np.arange(1, 6, dtype=np.int32)
    cold = np.arange(51, 56, dtype=np.int32)
    bh, bc = pool.alloc(1), pool.alloc(1)
    px.register(hot, bh)
    px.register(cold, bc)
    pool.free(bh)
    pool.free(bc)
    for _ in range(3):
        h = px.match_and_pin(hot)
        px.unpin(h.blocks)
    time.sleep(0.01)
    return [px.evict(1), px.peek(hot), px.peek(cold), px.evict(1),
            px.num_nodes]


def _pinned_untouchable(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    prompt = np.arange(1, 9, dtype=np.int32)
    blocks = pool.alloc(2)
    px.register(prompt, blocks)
    pool.free(blocks)
    hit = px.match_and_pin(np.concatenate([prompt, _tok(9)]))
    log = [px.evict(2), px.num_nodes]
    px.unpin(hit.blocks)
    return log + [px.evict(2), px.num_nodes]


def _preempt_while_shared_pool(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    prompt = np.arange(1, 13, dtype=np.int32)
    a_blocks = pool.alloc(3)
    px.register(prompt, a_blocks)
    pool.free(a_blocks)
    b_prompt = np.concatenate([prompt, _tok(91, 92, 93, 94, 95)])
    hit = px.match_and_pin(b_prompt)
    suffix = pool.alloc(2)
    pool.free_deferred(list(hit.blocks) + suffix)
    log = [_hit(hit), pool.num_deferred,
           [pool.refcount(b) for b in a_blocks], px.num_parked,
           px.peek(b_prompt)]
    pool.release_deferred()
    pool.release_deferred()
    return log + [pool.num_free, px.num_parked]


def _metrics_and_clear(Pool, Cache, Reg):
    pool = Pool(16, 4)
    px = Cache(pool)
    reg = Reg()
    px.set_metrics(reg)
    a = np.arange(1, 13, dtype=np.int32)
    b = np.concatenate([a[:4], np.arange(40, 48, dtype=np.int32)])
    ba, bb = pool.alloc(3), pool.alloc(3)
    px.register(a, ba)
    px.register(b, bb)
    pool.free(ba)
    pool.free(bb)
    px.match_and_pin(np.arange(90, 99, dtype=np.int32))      # a miss
    h = px.match_and_pin(np.concatenate([a, _tok(5)]))
    px.unpin(h.blocks)
    log = [_hit(h), reg.snapshot(), px.stats, px.num_parked]
    log += [px.clear(), px.num_nodes, pool.num_free, px.num_parked,
            reg.snapshot()]
    return log


def _export(px):
    """``export_nodes`` with the token arrays as lists (comparable)."""
    return [{**n, "tokens": n["tokens"].tolist()} for n in px.export_nodes()]


def _export_import_warm(Pool, Cache, Reg):
    """A trie exported from one pool and imported into a fresh pool's empty
    cache (the snapshot path): BFS order with parent indices, parked warm
    nodes, and the first live match counted in ``warm_hits``."""
    pool = Pool(16, 4)
    px = Cache(pool)
    a = np.arange(1, 13, dtype=np.int32)                     # 3 chunks
    b = np.concatenate([a[:4], np.arange(40, 48, dtype=np.int32)])
    ba, bb = pool.alloc(3), pool.alloc(3)
    px.register(a, ba)
    px.register(b, bb)
    pool.free(ba)
    pool.free(bb)
    h = px.match_and_pin(np.concatenate([a, _tok(5)]))       # hits += 1
    px.unpin(h.blocks)
    exported = _export(px)
    log = [exported]
    pool2 = Pool(16, 4)
    px2 = Cache(pool2)
    reg = Reg()
    px2.set_metrics(reg)
    ids = pool2.alloc(len(exported))
    log += [px2.import_nodes(px.export_nodes(), ids), px2.num_nodes,
            px2.num_parked, pool2.num_free, _export(px2)]
    h2 = px2.match_and_pin(np.concatenate([b, _tok(9)]))
    log += [_hit(h2), px2.stats, reg.snapshot()]
    px2.unpin(h2.blocks)
    px2.register(np.concatenate([np.arange(60, 68, dtype=np.int32)]),
                 pool2.alloc(2))                             # a cold chain
    h3 = px2.match_and_pin(np.arange(60, 69, dtype=np.int32))
    log += [_hit(h3), px2.stats, reg.snapshot()]
    return log


def _import_truncated(Pool, Cache, Reg):
    """Restore with fewer blocks than entries (a smaller pool): the tail
    of the BFS order is dropped, and a child whose parent was dropped is
    skipped with its subtree."""
    pool = Pool(32, 4)
    px = Cache(pool)
    a = np.arange(1, 17, dtype=np.int32)                     # 4 chunks
    c = np.concatenate([a[:4], np.arange(70, 78, dtype=np.int32)])
    for prompt, n in ((a, 4), (c, 3)):
        blocks = pool.alloc(n)
        px.register(prompt, blocks)
        pool.free(blocks)
    entries = px.export_nodes()
    log = [[e["parent"] for e in entries]]
    for keep in (2, 3, 5):
        pool2 = Pool(32, 4)
        px2 = Cache(pool2)
        created = px2.import_nodes(entries, pool2.alloc(keep))
        log += [keep, created, px2.num_nodes, px2.num_parked,
                px2.peek(np.concatenate([a, _tok(1)])),
                px2.peek(np.concatenate([c, _tok(1)]))]
    return log


TRIE_SCENARIOS = [_register_then_match, _cap_at_prompt_len_minus_one,
                  _partial_tail_best_divergence, _hash_collisions,
                  _register_skips_existing, _evict_leaf_first,
                  _evict_reuse_score, _pinned_untouchable,
                  _preempt_while_shared_pool, _metrics_and_clear,
                  _export_import_warm, _import_truncated]


@pytest.mark.parametrize("scenario", TRIE_SCENARIOS,
                         ids=[f.__name__.strip("_") for f in TRIE_SCENARIOS])
def test_trie_matches_reference(scenario):
    ref = scenario(*SIDES["jax"])
    got = scenario(*SIDES["torch"])
    assert got == ref


# ========================================================== engine layer
@functools.lru_cache(maxsize=None)
def _setup():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32")
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


def _engine(side, impl="kernel", **kw):
    cfg, jp, tp = _setup()
    if side == "jax":
        return JEngine(cfg, jp, paged_impl="gather", prefix_cache=True,
                       **kw)
    return ServeEngine(cfg, tp, device="cpu", paged_impl=impl,
                       prefix_cache=True, **kw)


def _rand(rng, n):
    return rng.integers(1, _setup()[0].vocab_size, size=n).astype(np.int32)


def _end_state(eng):
    """Stats, then the pool's accounting: free + parked covers every block
    while the trie holds its chains, and once it is evicted every block is
    free with refcount 0."""
    stats = dict(eng.stats)
    pool, px = eng._pool, eng._prefix
    parked = px.num_parked
    assert pool.num_free + parked == pool.num_blocks - 1
    assert px.evict(px.num_nodes) == parked
    assert px.num_nodes == 0
    assert pool.num_free == pool.num_blocks - 1
    assert all(pool.refcount(b) == 0 for b in range(1, pool.num_blocks))
    return stats


def _hit_batch(side, impl="kernel"):
    """Six prompts sharing a 40-token prefix: the first registers the
    chain, the other five (two admission groups on four slots) hit it."""
    rng = np.random.default_rng(11)
    common = _rand(rng, 40)
    prompts = [np.concatenate([common, _rand(rng, 6)]) for _ in range(6)]
    with _engine(side, impl, decode_chunk=2, block_size=8, prefill_chunk=16,
                 max_batch=4) as eng:
        outs = eng.generate(prompts[:1], max_new=8) \
            + eng.generate(prompts[1:], max_new=8)
        return [o.tolist() for o in outs], _end_state(eng)


def _partial_fork(side, common_len, impl="kernel"):
    """B shares A's prefix mid-block: B's admission forks A's cached tail
    block, and B's first window starts at the first uncached token."""
    rng = np.random.default_rng(12)
    common = _rand(rng, common_len)
    a = np.concatenate([common, _rand(rng, 56 - common_len)])
    b = np.concatenate([common, _rand(rng, 56 - common_len)])
    with _engine(side, impl, decode_chunk=2, block_size=8,
                 prefill_chunk=16) as eng:
        outs = [eng.generate([a], max_new=6)[0],
                eng.generate([b], max_new=6)[0]]
        return [o.tolist() for o in outs], _end_state(eng)


def _preempt_shared(side, impl="kernel"):
    rng = np.random.default_rng(13)
    common = _rand(rng, 8)
    prompts = [np.concatenate([common, _rand(rng, 4)]) for _ in range(2)]
    with _engine(side, impl, decode_chunk=4, kv_blocks=10,
                 block_size=4) as eng:
        outs = eng.generate(prompts, max_new=16)
        return [o.tolist() for o in outs], _end_state(eng)


def _cow_guard(side, impl="kernel"):
    """Pin the seated row's first block from outside, inside the decode
    stage right after the merge, so the same cycle's guard must fork it
    before the row's first decode write lands there."""
    pinned = []
    with _engine(side, impl, decode_chunk=1, block_size=16) as eng:
        merge = eng._merge_group

        def merge_then_pin(pf, payload):
            merge(pf, payload)
            if not pinned:
                blocks = next(b for b in eng._slot_blocks if b)
                eng._pool.incref([blocks[0]])
                pinned.append(blocks[0])

        eng._merge_group = merge_then_pin
        out = eng.generate([np.arange(1, 5, dtype=np.int32)], max_new=48)
        assert eng._pool.refcount(pinned[0]) == 1   # only our pin is left
        eng._pool.free(pinned)
        return [o.tolist() for o in out], _end_state(eng)


@functools.lru_cache(maxsize=None)
def _jax(name, *args):
    return {"hit_batch": _hit_batch, "partial_fork": _partial_fork,
            "preempt_shared": _preempt_shared,
            "cow_guard": _cow_guard}[name]("jax", *args)


PREFIX_STATS = ("prefix_hits", "prefix_tokens_saved", "cow_forks")


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_engine_hit_parity_and_savings(impl):
    ref, ref_stats = _jax("hit_batch")
    outs, stats = _hit_batch("torch", impl)
    assert outs == ref
    for k in PREFIX_STATS:
        assert stats[k] == ref_stats[k], k
    assert stats["prefix_hits"] == 5
    assert stats["prefix_tokens_saved"] == 5 * 40
    # the uncached engine emits the same tokens
    cfg, _, tp = _setup()
    rng = np.random.default_rng(11)
    common = _rand(rng, 40)
    prompts = [np.concatenate([common, _rand(rng, 6)]) for _ in range(6)]
    with ServeEngine(cfg, tp, device="cpu", paged_impl=impl, decode_chunk=2,
                     block_size=8, prefill_chunk=16, max_batch=4) as eng:
        assert eng._prefix is None
        base = [o.tolist() for o in eng.generate(prompts, max_new=8)]
    assert base == outs


@pytest.mark.parametrize("common_len", [44, 43])
def test_engine_partial_tail_cow_fork_parity(common_len):
    ref, ref_stats = _jax("partial_fork", common_len)
    outs, stats = _partial_fork("torch", common_len)
    assert outs == ref
    for k in PREFIX_STATS:
        assert stats[k] == ref_stats[k], k
    assert stats["cow_forks"] == 1 and stats["prefix_hits"] == 1
    assert stats["prefix_tokens_saved"] == common_len


def test_engine_preempt_while_shared_parity():
    ref, ref_stats = _jax("preempt_shared")
    outs, stats = _preempt_shared("torch")
    assert outs == ref
    for st in (stats, ref_stats):
        assert st["preempted"] >= 1
        assert st["admitted"] == 2 + st["preempted"]
        assert st["retired"] == 2
        assert 1 <= st["prefix_hits"] <= st["admitted"]


def test_engine_cow_guard_forks_artificially_shared_block():
    ref, ref_stats = _jax("cow_guard")
    outs, stats = _cow_guard("torch")
    assert outs == ref
    for k in PREFIX_STATS:
        assert stats[k] == ref_stats[k], k
    assert stats["cow_forks"] == 1


def test_prefix_cache_env_and_slot_archs(monkeypatch):
    cfg, _, tp = _setup()
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    with ServeEngine(cfg, tp, device="cpu") as eng:
        assert eng.prefix_cache and eng._prefix is not None
    monkeypatch.delenv("REPRO_PREFIX_CACHE")
    with ServeEngine(cfg, tp, device="cpu") as eng:
        assert not eng.prefix_cache and eng._prefix is None
    import torch
    from repro_torch.params import init_params
    mcfg = get_config("falcon-mamba-7b").smoke()
    mp = init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    with ServeEngine(mcfg, mp, device="cpu", prefix_cache=True) as eng:
        assert not eng.prefix_cache and eng._prefix is None


def test_smoke_first_flip_margin_matches_jax_logits():
    """``chip_smoke.py``'s report on a flipped token, on the CPU: the
    position where two token streams first differ, and the top-2 margin of
    the JAX model's logits after the prompt and the tokens before it
    (to the printed 5 significant digits)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, jp, tp = _setup()
    rng = np.random.default_rng(5)
    prompt = _rand(rng, 11)
    a = _rand(rng, 6).tolist()
    b = list(a)
    b[3] = a[3] + 1 if a[3] + 1 < cfg.vocab_size else a[3] - 1
    msg = smoke._first_flip_margin(cfg, tp, prompt, a, b, "cpu")
    seq = np.concatenate([prompt, np.asarray(a[:3], np.int32)])
    logits, _ = jlm.prefill(cfg, jp, seq[None])
    top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
    want = float(top2[1] - top2[0])
    head, margin = msg.split(", top-2 margin ")
    assert head == "token 3"
    assert abs(float(margin) - want) <= 1e-4 * abs(want) + 1e-6, (msg, want)
