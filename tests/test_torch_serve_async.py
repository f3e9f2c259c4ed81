"""The port's async decode lookahead (``ServeEngine(async_decode=True)``) on
the CPU, in fp32 at smoke size.

The scenarios of ``tests/test_serve_async.py`` on the torch engine: async
greedy tokens equal the synchronous engine's for mixed lengths, chunked
prefill, growth with preemption, qwen2-moe, falcon-mamba and zamba2 slots
(with an admission into a slot that retired in the chunk before), and the
prefix cache with copy-on-write forks; the stage log shows each chunk
dispatched before the previous one is synced; the metrics' dispatch /
sync / bookkeeping split is populated; a tight pool's stalled row gets the
fence-released blocks before new admissions; a preempted row's blocks are
never handed out while a chunk that may write them is in flight. On one
fixture the port's async tokens equal the JAX engine's ``async_decode=True``
tokens on its ``gather`` oracle (built once, jitted). The engine's exact
window and growth invariants (``tests/test_torch_serve.py``) hold in async
mode too. On the CPU the chunk runs eagerly (CUDA graphs are the card's;
``tests/test_torch_serve_async_gpu.py``).
"""
import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.launch import serve as launcher
from repro_torch.obs import Observability
from repro_torch.params import from_reference, init_params
from repro_torch.serve.engine import ServeEngine
from test_torch_serve import GEOM, check_stats, tally_discarded


@functools.lru_cache(maxsize=None)
def _setup(arch="stablelm-1.6b"):
    """(cfg, JAX params, the port's params) of ``arch``'s smoke config in
    fp32 compute; the port's weights are the reference's."""
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32")
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
            for s in lens]


def _pool_restored(eng) -> bool:
    """Every block free, or parked in the prefix trie."""
    parked = eng._prefix.num_parked if eng._prefix is not None else 0
    return eng._pool.num_free + parked == eng._pool.num_blocks - 1


def _both(cfg, params, prompts, max_new, tally=False, **kw):
    """Tokens of the sync and the async engine over ``prompts`` (as lists),
    the async engine, and (``tally``) each engine's stats and tally."""
    outs, seen = {}, {}
    for mode in (False, True):
        with ServeEngine(cfg, params, device="cpu", async_decode=mode,
                         **kw) as eng:
            t = tally_discarded(eng) if tally else None
            outs[mode] = [o.tolist() for o in eng.generate(prompts,
                                                           max_new)]
            seen[mode] = (dict(eng.stats), t)
    return outs[False], outs[True], eng, seen


def test_async_parity_mixed_lengths():
    cfg, _, tp = _setup()
    prompts = _prompts(cfg, (4, 7, 4, 5))
    sync, async_, eng, _ = _both(cfg, tp, prompts, 6, decode_chunk=4)
    assert sync == async_
    assert eng.async_decode and eng._pending is None
    assert eng.stats["retired"] == 4


def test_async_parity_chunked_prefill():
    """A prompt longer than the window streams windows while a resident
    row decodes; async completes each window a cycle after its launch."""
    cfg, _, tp = _setup()
    prompts = _prompts(cfg, (4, 20), seed=3)
    sync, async_, eng, _ = _both(cfg, tp, prompts, 10, decode_chunk=2,
                                 block_size=4, prefill_chunk=8)
    assert sync == async_
    assert eng.stats["prefill_windows"] >= 2


def test_async_parity_growth_preemption_and_exact_schedule():
    """The geometry of ``tests/test_torch_serve.py`` (chunked prefill, a
    pool tight enough to grow and preempt): equal tokens, the exact window
    and growth invariants on both engines, the fence drained and every
    block back."""
    cfg, _, tp = _setup()
    prompts = _prompts(cfg, [5, 9, 30, 3, 17, 12])
    sync, async_, eng, seen = _both(cfg, tp, prompts, 14, tally=True,
                                    **GEOM)
    assert sync == async_
    (s_stats, s_t), (a_stats, a_t) = seen[False], seen[True]
    assert a_stats["grown_blocks"] > 0 and a_stats["preempted"] > 0
    assert a_stats["prefill_windows"] > 0
    outs = [np.asarray(o) for o in async_]
    check_stats(a_stats, s_stats, outs, a_t, s_t, GEOM["max_admit"])
    assert eng._pool.num_deferred == 0
    assert _pool_restored(eng)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_async_parity_slot_archs(arch):
    cfg, _, tp = _setup(arch)
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(2, 10, dtype=np.int32),
               np.arange(4, 9, dtype=np.int32)]
    sync, async_, eng, _ = _both(cfg, tp, prompts, 6, decode_chunk=2,
                                 max_seq_len=64)
    assert not eng.paged
    assert sync == async_
    assert eng.stats["retired"] == 3


def test_async_reseat_slot_retired_in_previous_chunk():
    """Two slots, three requests: the short one retires while the long one
    decodes, and the third is seated in the freed slot while a chunk is in
    flight. That chunk steps the inactive slot in place; the seating's
    state writes follow it on the stream, so the newcomer's tokens are its
    solo run's."""
    cfg, _, tp = _setup("falcon-mamba-7b")
    a, b, c = (np.arange(1, 6, dtype=np.int32),
               np.arange(3, 12, dtype=np.int32),
               np.arange(7, 11, dtype=np.int32))
    kw = dict(decode_chunk=2, max_batch=2, max_seq_len=64)
    with ServeEngine(cfg, tp, device="cpu", **kw) as eng:
        solo = [eng.generate([p], m)[0].tolist()
                for p, m in ((a, 3), (b, 20), (c, 6))]
    with ServeEngine(cfg, tp, device="cpu", async_decode=True,
                     record_stages=True, **kw) as eng:
        reqs = [eng.submit(a, 3), eng.submit(b, 20), eng.submit(c, 6)]
        outs = [eng.result(r).tolist() for r in reqs]
        log = eng.stage_log
    assert outs == solo
    # c was admitted while b was still being dispatched (b's chunks
    # continue after c's admission)
    t_admit_c = next(t for s, _, info, t in log
                     if s == "admit" and reqs[2].id in info)
    assert any(s == "dispatch" and t > t_admit_c for s, _, _, t in log)


def test_async_parity_moe():
    cfg, _, tp = _setup("qwen2-moe-a2.7b")
    prompts = _prompts(cfg, [5, 9, 30, 3])
    sync, async_, eng, _ = _both(cfg, tp, prompts, 8, **GEOM)
    assert eng.paged and cfg.moe
    assert sync == async_


def test_async_parity_prefix_cache_with_forks():
    """A batch behind a registered prefix (hits) and a prompt sharing it
    mid-block (a copy-on-write fork at the merge), with the cache on."""
    cfg, _, tp = _setup()
    rng = np.random.default_rng(12)
    common = rng.integers(1, cfg.vocab_size, size=43).astype(np.int32)
    tails = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
             for n in (13, 5, 9, 7)]
    prompts = [np.concatenate([common, t]) for t in tails]
    kw = dict(decode_chunk=2, block_size=8, prefill_chunk=16, max_batch=4,
              prefix_cache=True)
    outs, stats = {}, {}
    for mode in (False, True):
        with ServeEngine(cfg, tp, device="cpu", async_decode=mode,
                         **kw) as eng:
            outs[mode] = [o.tolist() for o in
                          eng.generate(prompts[:1], 6)
                          + eng.generate(prompts[1:], 6)]
            stats[mode] = dict(eng.stats)
            assert _pool_restored(eng) and eng._pool.num_deferred == 0
    assert outs[False] == outs[True]
    st = stats[True]
    assert st["prefix_hits"] == 3 and st["cow_forks"] == 3
    assert st["prefix_tokens_saved"] == 3 * 43


def test_async_cow_guard_defers_the_original_reference():
    """Pin a seated row's first block from outside: the guard forks it and
    drops the row's reference through the fence; tokens stay the sync
    engine's."""
    cfg, _, tp = _setup()
    outs, fenced = {}, []
    for mode in (False, True):
        pinned = []
        with ServeEngine(cfg, tp, device="cpu", async_decode=mode,
                         decode_chunk=1, block_size=16,
                         prefix_cache=True) as eng:
            merge, fd = eng._merge_group, eng._pool.free_deferred

            def merge_then_pin(pf, payload):
                merge(pf, payload)
                if not pinned:
                    blocks = next(b for b in eng._slot_blocks if b)
                    eng._pool.incref([blocks[0]])
                    pinned.append(blocks[0])

            def free_deferred(ids):
                fenced.extend(ids)
                fd(ids)

            eng._merge_group = merge_then_pin
            eng._pool.free_deferred = free_deferred
            outs[mode] = eng.generate([np.arange(1, 5, dtype=np.int32)],
                                      max_new=40)[0].tolist()
            assert eng.stats["cow_forks"] == 1
            assert eng._pool.refcount(pinned[0]) == 1
            eng._pool.free(pinned)
    assert outs[False] == outs[True]
    assert fenced == pinned        # async only, and the original only


def test_async_dispatch_precedes_sync_in_stage_log():
    """Each sync names the dispatch it drains, an earlier cycle's; some
    cycle both dispatches and syncs (depth 2, not alternation)."""
    cfg, _, tp = _setup()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     async_decode=True, record_stages=True) as eng:
        eng.generate([np.arange(1, 6, dtype=np.int32)], max_new=12)
        ev = [(s, tok, info) for s, tok, info, _ in eng.stage_log
              if s in ("dispatch", "sync")]
    paired = [(tok, info[0]) for s, tok, info in ev if s == "sync"]
    assert paired, f"no sync events in {ev}"
    assert all(prev < tok for tok, prev in paired)
    disp = {tok for s, tok, _ in ev if s == "dispatch"}
    assert all(prev in disp for _, prev in paired)
    assert disp & {tok for s, tok, _ in ev if s == "sync"}
    kinds = [s for s, _, _ in ev]
    assert kinds.index("dispatch") < kinds.index("sync")


def test_async_metrics_split_populated():
    """Every cycle's seconds are dispatch, sync or bookkeeping; the gap
    (nothing in flight) is part of the bookkeeping."""
    cfg, _, tp = _setup()
    obs = Observability()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     async_decode=True, obs=obs) as eng:
        eng.generate([np.arange(1, 6, dtype=np.int32)], max_new=12)
    snap = obs.metrics.snapshot()
    cyc = snap["engine.cycle_s"]
    assert cyc["count"] >= 6        # 11 steps at chunk 2, one late sync
    parts = sum(snap[f"engine.{k}_s"]["sum"]
                for k in ("dispatch", "chunk_sync", "book"))
    assert parts == pytest.approx(cyc["sum"], rel=0.05)
    assert snap["engine.dispatch_s"]["count"] == cyc["count"]
    assert 0 <= snap["engine.gap_s"]["sum"] <= snap["engine.book_s"]["sum"]
    assert snap["serve.tokens_out"] == 11


def test_async_tight_pool_stall_yields_to_resident():
    """Every sequence must grow into all usable blocks: the stalled
    resident claims the fence-released blocks before new admissions (else
    an admit/preempt livelock); everything retires, tokens equal sync."""
    cfg, _, tp = _setup()
    prompts = [np.arange(1, 5, dtype=np.int32) for _ in range(3)]
    sync, async_, eng, _ = _both(cfg, tp, prompts, 12, decode_chunk=4,
                                 kv_blocks=5, block_size=4)
    assert sync == async_
    assert eng.stats["retired"] == 3
    assert eng._pool.num_deferred == 0
    assert _pool_restored(eng)


def test_engine_fence_blocks_not_reallocated_while_chunk_in_flight():
    """Check every alloc/grow result against a mirror of the fence: a
    preempted row's blocks are never handed out before two fence
    advances."""
    cfg, _, tp = _setup()
    prompts = _prompts(cfg, (16, 16), seed=1)
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=4, kv_blocks=10,
                     block_size=4, async_decode=True) as eng:
        pool = eng._pool
        lock = threading.Lock()
        young, old, defers, violations = set(), set(), [], []
        orig_alloc, orig_fd = pool.alloc, pool.free_deferred
        orig_rel = pool.release_deferred

        def alloc(n, **kw):
            ids = orig_alloc(n, **kw)
            with lock:
                if ids and (young | old) & set(ids):
                    violations.append(("alloc", ids))
            return ids

        def free_deferred(ids):
            with lock:
                fenced = [b for b in ids if pool.refcount(b) == 1]
                young.update(fenced)
                if fenced:
                    defers.append(fenced)
            orig_fd(ids)

        def release_deferred():
            with lock:
                old.clear()
                old.update(young)
                young.clear()
            return orig_rel()

        pool.alloc = alloc
        pool.free_deferred = free_deferred
        pool.release_deferred = release_deferred
        reqs = [eng.submit(p, max_new=16) for p in prompts]
        outs = [eng.result(r, timeout=240) for r in reqs]
        assert eng.stats["preempted"] >= 1
        assert defers, "preemption never went through the deferred fence"
        assert not violations, violations
        assert all(o.shape == (16,) for o in outs)


def test_async_tokens_equal_jax_async_engine():
    """The port's async engine against the JAX engine's async path on its
    gather oracle, at the geometry that grows and preempts."""
    cfg, jp, tp = _setup()
    prompts = _prompts(cfg, [5, 9, 30, 3, 17, 12])
    with JEngine(cfg, jp, paged_impl="gather", async_decode=True,
                 **GEOM) as jeng:
        ref = [o.tolist() for o in jeng.generate(prompts, max_new=14)]
    with ServeEngine(cfg, tp, device="cpu", async_decode=True,
                     paged_impl="gather", **GEOM) as eng:
        outs = [o.tolist() for o in eng.generate(prompts, max_new=14)]
    assert outs == ref


def test_tokens_handed_out_are_copies():
    """The chunk's output buffer and the pinned token buffers are the
    engine's: a returned array shares memory with neither."""
    cfg, _, tp = _setup()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     async_decode=True) as eng:
        outs = eng.generate(_prompts(cfg, (4, 6)), 5)
        bufs = [eng._chunk.out.numpy()] + [t.numpy() for t in eng._tok_host]
    for o in outs:
        assert not any(np.shares_memory(o, b) for b in bufs)


def test_chunk_graph_needs_cuda():
    cfg, _, tp = _setup()
    with pytest.raises(ValueError, match="CUDA"):
        ServeEngine(cfg, tp, device="cpu", chunk_graph=True)
    with ServeEngine(cfg, tp, device="cpu") as eng:
        assert eng._chunk.graph is None and not eng.async_decode


@pytest.mark.parametrize("async_decode", [False, True])
def test_close_drops_the_chunks_references_to_the_engine(async_decode):
    """A closed engine's chunk program holds nothing of the engine (its
    step and statics are dropped; on CUDA its graph is freed), so no
    captured graph waits in a reference cycle for the collector."""
    cfg, _, tp = _setup()
    eng = ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                      async_decode=async_decode)
    with eng:
        eng.generate(_prompts(cfg, (4, 6)), 3)
    assert eng._chunk._step is None and eng._chunk._statics is None
    eng.close()                           # idempotent


def test_async_env_switch(monkeypatch):
    cfg = get_config("stablelm-1.6b").smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    monkeypatch.setenv("REPRO_ASYNC_DECODE", "1")
    with ServeEngine(cfg, params, device="cpu") as eng:
        assert eng.async_decode
    with ServeEngine(cfg, params, device="cpu", async_decode=False) as eng:
        assert not eng.async_decode


def test_launcher_async_decode_serves_default_tokens(capsys):
    argv = ["--device", "cpu", "--batch", "3", "--prompt-len", "8",
            "--max-new", "9", "--decode-chunk", "4", "--stagger", "0.005"]
    base = [o.tolist() for o in launcher.main(argv)]
    outs = [o.tolist() for o in launcher.main(argv + ["--async-decode"])]
    assert outs == base
    assert "async_decode=True" in capsys.readouterr().out
