"""Durable serving on the port's engine, on the CPU: the journal, the
snapshot, drain and recover, and their crossing with the JAX package.

``tests/test_serve_durability.py`` scenario for scenario against the torch
engine (``device="cpu"``, stablelm and falcon-mamba smoke configs in fp32
compute, so that token comparisons are exact): the journal's round trip,
torn-tail truncation and fsync cadence; the snapshot container and its
typed corruption; the scheduler's ``export_waiting`` and hopeless head;
drain gating and the drain-deadline preemption (sync and async), with
``close`` failing the backlog typed; the journal's lifecycle records;
``recover`` replaying equal to an uninterrupted run; the warm restart; a
corrupt snapshot falling back cold; the ``snapshot_corrupt`` site; a drained
snapshot resubmitting its queue; falcon-mamba's boost and drain-deadline
checkpoint preemptions; close during a drain; the watchdog mid-drain.
Where the reference compares with its gather engine, these compare with
the port's uninterrupted engine.

Across the packages (the record and RSNAPv1 formats are the reference's):

* a journal the JAX engine wrote while it drained replays in the torch
  engine's ``recover()``, with the JAX engine's fp32 tokens;
* a JAX engine's snapshot restores into the torch engine with the same
  page bytes and a warm hit on the first request, and the reverse;
* the same request fields encode to the same journal bytes in both
  packages (timestamps aside).

The JAX engines are built once per module (each compiles its programs).
"""
import dataclasses
import functools
import json
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve import journal as jjournal
from repro.serve import snapshot as jsnapshot
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.obs import Observability
from repro_torch.params import from_reference
from repro_torch.serve import journal as tjournal
from repro_torch.serve.engine import JOURNAL_FILE, SNAPSHOT_FILE, ServeEngine
from repro_torch.serve.errors import (DeadlineExceeded, EngineClosed,
                                      ServeError, SnapshotCorrupt)
from repro_torch.serve.journal import Journal, replay
from repro_torch.serve.scheduler import Scheduler, ServeRequest
from repro_torch.serve.snapshot import (corrupt_snapshot, read_snapshot,
                                        write_snapshot)

GEOM = dict(max_batch=4, kv_blocks=64, block_size=8)


@functools.lru_cache(maxsize=None)
def _setup(arch="stablelm-1.6b", dt="float32"):
    """(cfg, JAX params, the port's params): ``arch``'s smoke config in
    ``dt`` compute (fp32 by default) with the reference's weights."""
    cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype=dt)
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    cfg, _, tp = _setup()
    return cfg, tp


@pytest.fixture(scope="module")
def ssm_setup():
    cfg, _, tp = _setup("falcon-mamba-7b")
    return cfg, tp


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **{**GEOM, **kw})


def _prompts(cfg, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in sizes]


@functools.lru_cache(maxsize=None)
def _solo(prompt: tuple, max_new: int) -> tuple:
    """The port's uninterrupted tokens of one prompt (the oracle of every
    replay here)."""
    cfg, _, tp = _setup()
    with _engine(cfg, tp) as eng:
        return tuple(eng.generate([np.asarray(prompt, np.int32)],
                                  max_new)[0].tolist())


def _ref(prompts, max_new):
    return [np.asarray(_solo(tuple(p.tolist()), max_new)) for p in prompts]


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class _Rec:
    """A request stand-in for the journal-only tests."""

    def __init__(self, rid, prompt, max_new=8, priority=0,
                 deadline_s=None):
        self.id = rid
        self.prompt = prompt
        self.max_new = max_new
        self.priority = priority
        self.deadline_s = deadline_s


# ----------------------------------------------------------------- journal
def test_journal_roundtrip_classifies(tmp_path):
    p = str(tmp_path / "j.wal")
    a = _Rec(1, np.arange(1, 5, dtype=np.int32))
    b = _Rec(2, np.arange(5, 12, dtype=np.int32), deadline_s=3.0)
    c = _Rec(3, np.arange(2, 9, dtype=np.int32))
    with Journal(p) as j:
        j.submit(a)
        j.submit(b)
        j.admit(a)
        j.first_token(a)
        j.finish(a, [7, 8, 9])
        j.submit(c)
        j.cancel(c, "cancelled")
    rep = replay(p)
    assert rep.dropped == 0
    assert set(rep.submits) == {1, 2, 3}
    assert rep.terminal == {1: "finish", 3: "cancel"}
    inc = rep.incomplete
    assert [r["id"] for r in inc] == [2]
    assert inc[0]["prompt"] == list(range(5, 12))
    assert inc[0]["deadline_s"] == 3.0
    assert rep.replayed_tokens == 7


def test_journal_torn_tail_truncates(tmp_path):
    p = str(tmp_path / "j.wal")
    with Journal(p) as j:
        for i in range(4):
            j.submit(_Rec(i, np.arange(1, 4, dtype=np.int32)))
    with open(p, "ab") as f:                    # torn final write
        f.write(b"deadbeef {\"k\": \"subm")
    rep = replay(p)
    assert len(rep.submits) == 4 and rep.dropped == 1
    lines = open(p, "rb").readlines()           # corruption mid-file
    lines[2] = b"00000000 {}\n"
    with open(p, "wb") as f:
        f.writelines(lines)
    rep = replay(p)
    assert len(rep.submits) == 2 and rep.dropped == 3


def test_journal_fsync_cadence_and_lag(tmp_path):
    p = str(tmp_path / "j.wal")
    j = Journal(p, fsync_every=0)               # fsync only on flush/close
    j.submit(_Rec(1, np.arange(3, dtype=np.int32)))
    assert j.lag_s >= 0.0
    time.sleep(0.02)
    assert j.lag_s > 0.0                        # un-fsynced data at risk
    j.flush()
    assert j.lag_s == 0.0
    j.close()
    j.close()                                   # idempotent
    with pytest.raises(ValueError):
        Journal(str(tmp_path / "x.wal"), fsync_every=-1)


def test_journal_batch_writes_once_with_the_same_records(tmp_path):
    plain, grouped = str(tmp_path / "a.wal"), str(tmp_path / "b.wal")
    recs = [_Rec(i, np.arange(3, dtype=np.int32) + i) for i in range(3)]
    with Journal(plain, fsync_every=1) as j:
        for r in recs:
            j.admit(r)
        j.finish(recs[0], [5, 6])
    with Journal(grouped, fsync_every=1) as j:
        with j.batch():
            for r in recs:
                j.admit(r)
            with j.batch():                     # joins the outer batch
                j.finish(recs[0], [5, 6])
            assert os.path.getsize(grouped) == 0     # nothing written yet
        assert j.records_written == 4 and j._since_sync == 0
        with pytest.raises(RuntimeError):
            with j.batch():
                j.cancel(recs[1], "cancelled")
                raise RuntimeError("a failing engine step")
        assert j.records_written == 5          # written on the way out

    def strip(path):
        return [{k: v for k, v in r.items() if k != "t"}
                for r in replay(path).records]
    assert strip(grouped)[:4] == strip(plain)
    assert strip(grouped)[4] == {"k": "cancel", "id": 1, "why": "cancelled"}


def test_journal_that_cannot_open_raises(setup, tmp_path):
    cfg, tp = setup
    bad = str(tmp_path / "missing_dir" / "j.wal")
    with pytest.raises(OSError):
        _engine(cfg, tp, journal=bad)


# ---------------------------------------------------------------- snapshot
def test_snapshot_container_roundtrip(tmp_path):
    p = str(tmp_path / "s.snap")
    meta = {"queue": [{"id": 4}], "note": "x"}
    arrs = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
            "b": np.zeros((0,), np.float32)}
    n = write_snapshot(p, meta, arrs)
    assert n == os.path.getsize(p)
    m2, a2 = read_snapshot(p)
    assert m2["queue"] == [{"id": 4}] and m2["version"] == 1
    assert np.array_equal(a2["a"], arrs["a"]) and a2["b"].size == 0


def test_snapshot_corruption_typed(tmp_path):
    p = str(tmp_path / "s.snap")
    write_snapshot(p, {}, {"a": np.arange(64, dtype=np.int32)})
    blob = open(p, "rb").read()
    corrupt_snapshot(p)                         # payload bit flip
    with pytest.raises(SnapshotCorrupt):
        read_snapshot(p)
    with open(p, "wb") as f:                    # torn write
        f.write(blob[:-7])
    with pytest.raises(SnapshotCorrupt):
        read_snapshot(p)
    with open(p, "wb") as f:                    # bad magic
        f.write(b"NOTASNAP" + blob[8:])
    with pytest.raises(SnapshotCorrupt):
        read_snapshot(p)
    with pytest.raises(SnapshotCorrupt):        # missing file
        read_snapshot(str(tmp_path / "missing.snap"))
    assert issubclass(SnapshotCorrupt, ServeError)


# ------------------------------------------------------------- scheduler
def test_scheduler_hopeless_head_fails_typed():
    s = Scheduler(max_admit=4)
    doomed = ServeRequest(np.arange(1, 9, dtype=np.int32), 64,
                          deadline_s=0.01)
    fine = ServeRequest(np.arange(1, 5, dtype=np.int32), 4)
    doomed.deadline_at = time.perf_counter() + 0.01
    for r in (doomed, fine):
        s.enqueue(r)
    events = []
    s.on_event = lambda kind, r: events.append((kind, r.id))
    group = s.try_admit(free_slots=4, blocks_free=None,
                        hopeless=lambda r: "too slow"
                        if r is doomed else None)
    assert group == [fine]
    assert events == [("expired", doomed.id)]
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=1.0)


def test_scheduler_export_waiting():
    s = Scheduler(max_admit=4)
    reqs = [ServeRequest(np.arange(1, 5, dtype=np.int32), 4, priority=p)
            for p in (1, 0, 1)]
    for r in reqs:
        s.enqueue(r)
    reqs[2].cancel()
    assert s.export_waiting() == [reqs[1], reqs[0]]   # tier order


# -------------------------------------------------------------------- drain
@pytest.mark.parametrize("async_decode", [False, True])
def test_drain_lets_residents_finish_then_gates(setup, async_decode):
    cfg, tp = setup
    prompts = _prompts(cfg, (12, 9))
    ref = _ref(prompts, 8)
    eng = _engine(cfg, tp, async_decode=async_decode)
    reqs = [eng.submit(p, 8) for p in prompts]
    _wait(lambda: all(r.admitted_at is not None for r in reqs),
          what="rows seated")
    assert eng.drain(deadline_s=30.0)           # generous: they finish
    assert eng._pending is None                 # no chunk in flight
    outs = [eng.result(r) for r in reqs]
    assert all(np.array_equal(a, b) for a, b in zip(ref, outs))
    assert eng.stats["drain_preempted"] == 0
    with pytest.raises(EngineClosed):           # the admission gate
        eng.submit(prompts[0], 4)
    eng.drain()                                 # idempotent
    eng.close()


@pytest.mark.parametrize("async_decode", [False, True])
def test_drain_deadline_preempts_and_close_fails_backlog_typed(
        setup, async_decode):
    cfg, tp = setup
    prompts = _prompts(cfg, (10, 11, 9), seed=3)
    eng = _engine(cfg, tp, max_batch=2, decode_chunk=2,
                  async_decode=async_decode)
    reqs = [eng.submit(p, 200) for p in prompts]
    _wait(lambda: any(r.first_token_at is not None for r in reqs),
          what="decode in flight")
    assert eng.drain(deadline_s=0.05, timeout=60.0)
    assert eng.stats["drain_preempted"] > 0
    assert sum(r is not None for r in eng._slot_req) == 0
    eng.close(timeout=10.0)
    for r in reqs:                              # typed, never hung
        with pytest.raises(ServeError):
            r.result(timeout=5.0)
    assert eng._pool.num_free == eng._pool.num_blocks - 1


@pytest.mark.parametrize("async_decode", [False, True])
def test_drained_backlog_rearms_no_run(setup, async_decode):
    # admission is closed: a drained engine's backlog must not restart the
    # pipeline (each run would stop at once and re-arm the next, and
    # drain() would settle only on an idle moment of that loop)
    cfg, tp = setup
    prompts = _prompts(cfg, (10, 11, 9), seed=3)
    eng = _engine(cfg, tp, max_batch=2, decode_chunk=2,
                  async_decode=async_decode)
    reqs = [eng.submit(p, 200) for p in prompts]
    _wait(lambda: any(r.first_token_at is not None for r in reqs),
          what="decode in flight")
    assert eng.drain(deadline_s=0.0, timeout=60.0)
    assert eng._scheduler.num_waiting == len(prompts)
    pl, runs = eng._pipeline, []
    run = pl.run
    pl.run = lambda *a, **k: runs.append(1) or run(*a, **k)
    time.sleep(0.2)
    assert runs == [] and pl.idle()
    eng.close(timeout=10.0)


# --------------------------------------------------- journal on the engine
def test_journal_records_engine_lifecycle(setup, tmp_path):
    cfg, tp = setup
    prompts = _prompts(cfg, (12, 9), seed=1)
    jp = str(tmp_path / JOURNAL_FILE)
    ref = _ref(prompts, 8)
    obs = Observability()
    eng = _engine(cfg, tp, journal=Journal(jp), obs=obs)
    outs = [eng.result(r) for r in [eng.submit(p, 8) for p in prompts]]
    eng.close()
    assert all(np.array_equal(a, b) for a, b in zip(ref, outs))
    rep = replay(jp)
    kinds = [r["k"] for r in rep.records]
    for k in ("submit", "admit", "first_token", "finish"):
        assert kinds.count(k) == 2, (k, kinds)
    assert rep.incomplete == []
    assert obs.metrics.get("journal.records").value == len(kinds)


class _SlowJournal(Journal):
    """A journal whose submit write takes a millisecond and releases the
    GIL meanwhile, as a slow disk's would."""

    def submit(self, req):
        time.sleep(0.001)
        super().submit(req)


def test_journaled_burst_is_admitted_whole(setup, tmp_path):
    # each journaled submit hands the GIL to the admit stage; an idle
    # engine waits for the submits in progress, so the burst is seated in
    # one admission as an unjournaled burst is, not one request at a time
    cfg, tp = setup
    prompts = _prompts(cfg, (8, 8, 8, 8), seed=5)
    jp = str(tmp_path / JOURNAL_FILE)
    with _engine(cfg, tp, journal=_SlowJournal(jp, fsync_every=0)) as eng:
        for rnd in range(3):
            for k in eng.stats:
                eng.stats[k] = 0
            reqs = [eng.submit(p, 6) for p in prompts]
            outs = [eng.result(r) for r in reqs]
            assert len({r.admitted_at for r in reqs}) == 1, rnd
            assert eng.stats["prefills"] == 1, rnd
    assert all(np.array_equal(a, b) for a, b in zip(_ref(prompts, 6), outs))


def test_journal_records_cancel_and_expiry(setup, tmp_path):
    cfg, tp = setup
    jp = str(tmp_path / JOURNAL_FILE)
    eng = _engine(cfg, tp, max_batch=1, decode_chunk=2, journal=jp)
    p = _prompts(cfg, (10, 9, 8), seed=13)
    seated = eng.submit(p[0], 120)
    queued = eng.submit(p[1], 8)
    doomed = eng.submit(p[2], 8, deadline_s=0.01)
    _wait(lambda: seated.first_token_at is not None, what="row seated")
    queued.cancel()
    seated.cancel()
    for r in (seated, queued, doomed):
        with pytest.raises(ServeError):
            r.result(timeout=30.0)
    eng.close()
    rep = replay(jp)
    assert rep.terminal == {seated.id: "cancel", queued.id: "cancel",
                            doomed.id: "cancel"}
    whys = {r["id"]: r["why"] for r in rep.records if r["k"] == "cancel"}
    assert whys == {seated.id: "cancelled", queued.id: "cancelled",
                    doomed.id: "expired"}


def test_recover_replays_incomplete_bit_identical(setup, tmp_path):
    cfg, tp = setup
    prompts = _prompts(cfg, (12, 9, 17), seed=2)
    ref = _ref(prompts, 8)
    state = tmp_path / "state"
    state.mkdir()
    with Journal(str(state / JOURNAL_FILE)) as j:   # a crashed journal
        for i, p in enumerate(prompts):
            j.submit(_Rec(10 + i, p, max_new=8))
        j.finish(_Rec(11, prompts[1]), ref[1])
    obs = Observability()
    eng = _engine(cfg, tp, obs=obs)
    replayed = eng.recover(str(state))
    assert sorted(replayed) == [10, 12]         # the finished one skipped
    assert np.array_equal(eng.result(replayed[10]), ref[0])
    assert np.array_equal(eng.result(replayed[12]), ref[2])
    assert eng.stats["recovered"] == 2
    ntok = len(prompts[0]) + len(prompts[2])
    assert eng.stats["replayed_tokens"] == ntok
    assert obs.metrics.get("serve.recovered").value == 2
    assert obs.metrics.get("serve.replayed_tokens").value == ntok
    assert (state / (JOURNAL_FILE + ".replayed")).exists()
    eng.drain()
    rep = replay(str(state / JOURNAL_FILE))
    assert len(rep.submits) == 2 and len(rep.incomplete) == 0
    eng.close()


# ------------------------------------------------------------- warm restart
def _system_prompts(cfg, seed=4, n=2):
    system = np.arange(1, 25, dtype=np.int32)   # a shared system prompt
    return [np.concatenate([system, t])
            for t in _prompts(cfg, (8, 6, 7)[:n], seed=seed)]


def test_snapshot_warm_restart_first_request_hits(setup, tmp_path):
    cfg, tp = setup
    prompts = _system_prompts(cfg)
    state = tmp_path / "state"
    state.mkdir()
    eng = _engine(cfg, tp, prefix_cache=True,
                  journal=Journal(str(state / JOURNAL_FILE)))
    ref = [eng.result(r) for r in [eng.submit(p, 8) for p in prompts]]
    assert eng.drain(deadline_s=10.0)
    eng.snapshot(str(state / SNAPSHOT_FILE))
    eng.close()

    obs = Observability()
    eng2 = _engine(cfg, tp, prefix_cache=True, obs=obs)
    ptr = eng2._pkv.data_ptr()
    assert eng2.recover(str(state)) == {}       # nothing incomplete
    assert eng2.stats["warm_started"] > 0
    assert eng2._pkv.data_ptr() == ptr          # written in place
    out = eng2.result(eng2.submit(prompts[0], 8))
    assert eng2._prefix.stats["warm_hits"] > 0
    assert obs.metrics.get("prefix.warm_hits").value > 0
    assert np.array_equal(out, ref[0])
    eng2.close()


def test_corrupt_snapshot_falls_back_cold_never_wrong(setup, tmp_path):
    cfg, tp = setup
    prompts = _prompts(cfg, (12, 9), seed=5)
    state = tmp_path / "state"
    state.mkdir()
    eng = _engine(cfg, tp, prefix_cache=True)
    ref = [eng.result(r) for r in [eng.submit(p, 8) for p in prompts]]
    assert eng.drain()
    eng.snapshot(str(state / SNAPSHOT_FILE))
    eng.close()
    corrupt_snapshot(str(state / SNAPSHOT_FILE))

    eng2 = _engine(cfg, tp, prefix_cache=True)
    with pytest.raises(SnapshotCorrupt):        # restore() is typed
        eng2.restore(str(state / SNAPSHOT_FILE))
    eng2.recover(str(state))                    # recover() goes cold
    assert eng2.stats["warm_started"] == 0
    outs = [eng2.result(r) for r in [eng2.submit(p, 8) for p in prompts]]
    assert all(np.array_equal(a, b) for a, b in zip(ref, outs))
    eng2.close()


def test_snapshot_geometry_mismatch_is_typed(setup, tmp_path):
    cfg, tp = setup
    sp = str(tmp_path / SNAPSHOT_FILE)
    with _engine(cfg, tp, prefix_cache=True) as eng:
        eng.result(eng.submit(_system_prompts(cfg)[0], 4))
        assert eng.drain()
        eng.snapshot(sp)
    with _engine(cfg, tp, prefix_cache=True, block_size=4) as other:
        with pytest.raises(SnapshotCorrupt, match="geometry"):
            other.restore(sp)
        assert other.stats["warm_started"] == 0


def test_snapshot_corrupt_fault_site(setup, tmp_path):
    cfg, tp = setup
    sp = str(tmp_path / SNAPSHOT_FILE)
    eng = _engine(cfg, tp, max_batch=2, kv_blocks=32, prefix_cache=True,
                  fault_inject="snapshot_corrupt")
    eng.result(eng.submit(_prompts(cfg, (12,), seed=6)[0], 4))
    assert eng.drain()
    eng.snapshot(sp)
    eng.close()
    with pytest.raises(SnapshotCorrupt):
        read_snapshot(sp)


def test_restore_from_drained_snapshot_resubmits_queue(setup, tmp_path):
    cfg, tp = setup
    prompts = _prompts(cfg, (10, 11, 9), seed=7)
    ref = _ref(prompts, 32)
    state = tmp_path / "state"
    state.mkdir()
    # no journal: the snapshot's queue descriptors are the only record
    eng = _engine(cfg, tp, max_batch=2, decode_chunk=2)
    reqs = [eng.submit(p, 32) for p in prompts]
    _wait(lambda: any(r.admitted_at is not None for r in reqs),
          what="rows seated")
    eng.drain(deadline_s=0.0, timeout=60.0)     # checkpoint-preempt now
    eng.snapshot(str(state / SNAPSHOT_FILE))
    eng.close()
    eng2 = _engine(cfg, tp, max_batch=2, decode_chunk=2)
    replayed = eng2.recover(str(state))
    assert len(replayed) > 0                    # the drained backlog
    for r in replayed.values():
        out = eng2.result(r, timeout=120.0)
        assert any(np.array_equal(out, x) for x in ref)
    eng2.close()


# --------------------------------------------- SSM checkpoint preemption
def test_ssm_boost_preempt_checkpoint_no_replay(ssm_setup):
    cfg, tp = ssm_setup
    prompts = _prompts(cfg, (10, 11, 9), seed=9)
    with ServeEngine(cfg, tp, max_batch=4, device="cpu") as ref_eng:
        ref = [ref_eng.result(r)
               for r in [ref_eng.submit(p, 24) for p in prompts]]
    eng = ServeEngine(cfg, tp, max_batch=2, decode_chunk=2, device="cpu")
    lo = [eng.submit(p, 24, priority=1) for p in prompts[:2]]
    _wait(lambda: all(r.first_token_at is not None for r in lo),
          what="low-tier rows decoding")
    hi = eng.submit(prompts[2], 24, priority=0)
    outs = [eng.result(r, timeout=120.0) for r in lo] \
        + [eng.result(hi, timeout=120.0)]
    assert eng.stats["preempted"] > 0           # the boost fired
    assert eng.stats["prefills"] == len(prompts)   # restored, not replayed
    assert all(np.array_equal(a, b) for a, b in zip(ref, outs))
    eng.close()


def test_ssm_drain_deadline_checkpoint_preempts(ssm_setup):
    cfg, tp = ssm_setup
    prompts = _prompts(cfg, (10, 9), seed=10)
    eng = ServeEngine(cfg, tp, max_batch=2, decode_chunk=2, device="cpu")
    reqs = [eng.submit(p, 200) for p in prompts]
    _wait(lambda: all(r.first_token_at is not None for r in reqs),
          what="rows decoding")
    assert eng.drain(deadline_s=0.05, timeout=60.0)
    assert eng.stats["drain_preempted"] > 0
    # the checkpoints captured exact state on the way out
    assert all(r._ssm_ckpt is not None or r.done() for r in reqs)
    eng.close(timeout=10.0)
    for r in reqs:
        with pytest.raises(ServeError):
            r.result(timeout=5.0)


# -------------------------------------------------------- teardown interplay
def test_close_during_active_drain_settles_everything(setup):
    cfg, tp = setup
    prompts = _prompts(cfg, (10, 11), seed=11)
    eng = _engine(cfg, tp, max_batch=2, decode_chunk=2)
    reqs = [eng.submit(p, 200) for p in prompts]
    _wait(lambda: any(r.first_token_at is not None for r in reqs),
          what="decode in flight")
    t = threading.Thread(target=eng.drain,
                         kwargs={"deadline_s": 120.0, "timeout": 120.0})
    t.start()
    time.sleep(0.2)
    eng.close(timeout=5.0)                      # close races the drain
    t.join(timeout=30.0)
    assert not t.is_alive()
    for r in reqs:                              # typed or done, never hung
        try:
            r.result(timeout=5.0)
        except ServeError:
            pass


def test_watchdog_fires_mid_drain(setup):
    cfg, tp = setup
    eng = _engine(cfg, tp, max_batch=2, decode_chunk=2, watchdog_s=0.3,
                  fault_inject="chunk_latency:at=2,ms=1500")
    r = eng.submit(_prompts(cfg, (10,), seed=12)[0], 64)
    _wait(lambda: r.admitted_at is not None, what="row seated")
    eng.drain(deadline_s=30.0, timeout=30.0)
    with pytest.raises(ServeError):             # typed; nothing hangs
        r.result(timeout=10.0)
    assert eng.stats["watchdog_fires"] > 0
    eng.close(timeout=5.0)


# ------------------------------------------------- across the two packages
def test_journal_bytes_equal_across_packages(tmp_path):
    rec = {"k": "submit", "t": 1.5, "id": 7, "prompt": [3, 1, 4],
           "max_new": 8, "priority": 1, "deadline_s": None}
    assert tjournal._encode(rec) == jjournal._encode(rec)
    r = _Rec(7, np.asarray([3, 1, 4, 1, 5], np.int32), max_new=9,
             priority=1, deadline_s=2.5)
    lines = {}
    for name, mod in (("torch", tjournal), ("jax", jjournal)):
        p = str(tmp_path / f"{name}.wal")
        with mod.Journal(p) as j:
            j.submit(r)
            j.admit(r)
            j.first_token(r)
            j.finish(r, [9, 8, 7])
            j.cancel(r, "expired")
        recs = []
        for line in open(p, "rb").read().splitlines(keepends=True):
            d = mod._decode(line)
            assert d is not None and d.pop("t") > 0
            recs.append(mod._encode({**d, "t": 0.0}))
        lines[name] = recs
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 5


@pytest.fixture(scope="module")
def jax_drained(tmp_path_factory):
    """A JAX engine (fp32, prefix cache, one row) that served three
    system-prompt requests uninterrupted, then took the same three with a
    journal attached and was drained at a 0 s deadline right after the
    first was seated (its row checkpoint-preempted, the two others never
    admitted), snapshotted and closed: its journal holds three incomplete
    requests and its snapshot the trie, its pages and the queue."""
    cfg, jp, _ = _setup()
    prompts = _system_prompts(cfg, seed=14, n=3)
    state = tmp_path_factory.mktemp("jax-state")
    with JEngine(cfg, jp, max_batch=1, kv_blocks=64, block_size=8,
                 decode_chunk=2, paged_impl="gather",
                 prefix_cache=True) as eng:
        ref = [np.asarray(o) for o in eng.generate(prompts, 8)]
        eng.set_journal(jjournal.Journal(str(state / JOURNAL_FILE)))
        reqs = [eng.submit(p, 8) for p in prompts]
        _wait(lambda: reqs[0].admitted_at is not None, what="JAX row seated")
        assert eng.drain(deadline_s=0.0, timeout=60.0)
        eng.snapshot(str(state / SNAPSHOT_FILE))
    return cfg, prompts, ref, [r.id for r in reqs], state


def test_jax_journal_replays_in_torch_engine(jax_drained, tmp_path):
    cfg, prompts, ref, ids, state = jax_drained
    _, _, tp = _setup()
    mine = tmp_path / "state"
    mine.mkdir()
    shutil.copy(state / JOURNAL_FILE, mine / JOURNAL_FILE)   # no snapshot
    rep = jjournal.replay(str(mine / JOURNAL_FILE))
    incomplete = {r["id"] for r in rep.incomplete}
    assert len(incomplete) >= 2                 # the queued two at least
    eng = _engine(cfg, tp)
    replayed = eng.recover(str(mine))
    assert set(replayed) == incomplete
    for i, rid in enumerate(ids):
        if rid in replayed:
            out = eng.result(replayed[rid], timeout=120.0)
            assert np.array_equal(out, ref[i]), f"request {rid}"
    eng.close()


def _pages_by_key(meta, arrays):
    """{chunk key: raw page bytes} of a snapshot's trie."""
    return {e["key"]: arrays["prefix_pages"][:, :, i]
            for i, e in enumerate(meta["prefix"])}


def _pool_bytes(pool, block):
    """One block's page of a pool (L, 2, N, KV, bs, hd) as raw bytes."""
    if isinstance(pool, torch.Tensor):
        return pool[:, :, block].contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(pool)[:, :, block]) \
        .view(np.uint8)


def test_jax_snapshot_restores_into_torch_engine(jax_drained):
    cfg, prompts, ref, ids, state = jax_drained
    _, _, tp = _setup()
    meta, arrays = jsnapshot.read_snapshot(str(state / SNAPSHOT_FILE))
    want = _pages_by_key(meta, arrays)
    eng = _engine(cfg, tp, prefix_cache=True)
    ptr = eng._pkv.data_ptr()
    queue = eng.restore(str(state / SNAPSHOT_FILE))
    assert [d["id"] for d in queue] == [d["id"] for d in meta["queue"]]
    assert eng.stats["warm_started"] == len(meta["prefix"])
    assert eng._pkv.data_ptr() == ptr
    nodes = eng._prefix.export_nodes()
    assert sorted(n["key"] for n in nodes) == sorted(want)
    for n in nodes:
        assert np.array_equal(_pool_bytes(eng._pkv, n["block"]),
                              want[n["key"]]), n["key"]
    out = eng.result(eng.submit(prompts[0], 8))
    assert eng._prefix.stats["warm_hits"] >= 1
    assert np.array_equal(out, ref[0])
    eng.close()


def test_torch_snapshot_restores_into_jax_engine(setup, tmp_path):
    cfg, tp = setup
    _, jp, _ = _setup()
    prompts = _system_prompts(cfg, seed=15)
    sp = str(tmp_path / SNAPSHOT_FILE)
    with _engine(cfg, tp, prefix_cache=True) as eng:
        ref = [eng.result(r) for r in [eng.submit(p, 8) for p in prompts]]
        assert eng.drain()
        eng.snapshot(sp)
    meta, arrays = read_snapshot(sp)
    assert meta["pool_dtype"] == "float32"
    want = _pages_by_key(meta, arrays)
    with JEngine(cfg, jp, **GEOM, paged_impl="gather",
                 prefix_cache=True) as jeng:
        jeng.restore(sp)
        assert jeng.stats["warm_started"] == len(meta["prefix"])
        for n in jeng._prefix.export_nodes():
            assert np.array_equal(_pool_bytes(jeng._pkv, n["block"]),
                                  want[n["key"]]), n["key"]
        out = jeng.result(jeng.submit(prompts[0], 8))
        assert jeng._prefix.stats["warm_hits"] >= 1
        assert np.array_equal(np.asarray(out), ref[0])


def test_bf16_snapshot_pages_are_raw_bytes(tmp_path):
    cfg, _, tp = _setup("stablelm-1.6b", "bfloat16")
    sp = str(tmp_path / SNAPSHOT_FILE)
    prompts = _system_prompts(cfg, seed=16, n=1)
    with _engine(cfg, tp, prefix_cache=True) as eng:
        assert eng._pkv.dtype == torch.bfloat16
        eng.result(eng.submit(prompts[0], 4))
        assert eng.drain()
        eng.snapshot(sp)
    meta, arrays = read_snapshot(sp)
    assert meta["pool_dtype"] == "bfloat16"
    assert arrays["prefix_pages"].dtype == np.uint8
    with _engine(cfg, tp, prefix_cache=True) as eng2:
        eng2.restore(sp)
        for n in eng2._prefix.export_nodes():
            got = _pool_bytes(eng2._pkv, n["block"])
            assert np.array_equal(got, _pages_by_key(meta, arrays)[n["key"]])
    # the reference reads the same bytes back as its own bfloat16
    jmeta, jarrays = jsnapshot.read_snapshot(sp)
    assert json.dumps(jmeta, sort_keys=True) == json.dumps(meta,
                                                           sort_keys=True)
