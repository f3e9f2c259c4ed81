"""SLO overload control and fault tolerance of the port's serve engine, on
the CPU.

``tests/test_serve_robustness.py`` test for test against the torch engine
(``device="cpu"``, stablelm smoke in fp32 compute; sync and async where the
reference runs both): the tiered scheduler (the port's copy), deadline
expiry queued and seated, ``cancel()`` from every state, load shedding
(typed ``Overloaded``), per-row failure isolation, the watchdog, typed
teardown and the fault injector. Where the reference compares with its
contiguous decode, these compare with the port's fault-free engine.

Then parity with the JAX package:

* the port's ``FaultInjector`` fires on the reference's schedule for the
  same spec, over 200 opportunities, and rejects the same bad specs with
  the same exception type;
* on one fixed trace under the benign spec (admission and growth
  failures, forced preemptions) the port's tokens equal the JAX gather
  engine's under that spec and the port's fault-free run, sync and async,
  with the exact window and growth invariants of
  ``tests/test_torch_serve.py``;
* ``_estimated_wait_s`` and ``_hopeless_why`` give the reference's numbers
  for the same service rate, mirrors and queue;
* falcon-mamba and zamba2 under ``preempt:every=3`` (sync): the port
  checkpoint-preempts slot rows (the reference consults the ``preempt``
  site on its paged path only, so its run is fault-free) and emits the
  JAX engine's tokens with one prefill per request.

The cancel repair: a seated ``cancel()`` fails ``RequestCancelled`` and its
slot and blocks come back. Every JAX oracle is built once per module.
"""
import dataclasses
import functools
import re
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve import faultinject as jfi
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ServeRequest as JRequest
from repro_torch.launch import serve as launcher
from repro_torch.obs import Observability
from repro_torch.params import from_reference
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (DeadlineExceeded, EngineClosed,
                                      Overloaded, RequestCancelled,
                                      RowFailed, ServeError,
                                      WatchdogTimeout)
from repro_torch.serve.faultinject import (SITES, FaultInjected,
                                           FaultInjector)
from repro_torch.serve.scheduler import Scheduler, ServeRequest
from test_torch_serve import GEOM, check_stats, tally_discarded

#: the benign spec of the chip check (admission and growth failures at 5%,
#: a forced preemption every 5th growth pass)
BENIGN = "alloc_fail:p=0.05,seed=11;grow_fail:p=0.05,seed=11;preempt:every=5"


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


@pytest.fixture(scope="module")
def setup():
    cfg, _, tp = _setup()
    return cfg, tp


def _pool_restored(eng) -> bool:
    parked = eng._prefix.num_parked if eng._prefix is not None else 0
    return eng._pool.num_free + parked == eng._pool.num_blocks - 1


def _wait_idle(eng, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if eng._pipeline.idle() and eng._scheduler.num_waiting == 0:
            return
        time.sleep(0.01)
    raise TimeoutError("engine did not go idle")


@functools.lru_cache(maxsize=None)
def _solo(n: int, prompt=tuple(range(1, 6))):
    """The port's fault-free tokens of one prompt (the mirrors' stand-in
    for the reference's contiguous decode)."""
    cfg, _, tp = _setup()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2) as eng:
        return eng.generate([np.asarray(prompt, np.int32)], n)[0].tolist()


P = np.arange(1, 6, dtype=np.int32)


# --------------------------------------------------------------- scheduler
def _req(prio=0, deadline_s=None, size=4):
    return ServeRequest(np.arange(1, 1 + size, dtype=np.int32), 4,
                        priority=prio, deadline_s=deadline_s)


def _stamp(r):
    """Stamp the absolute deadline the engine's submit() would."""
    r.submitted_at = time.perf_counter()
    if r.deadline_s is not None:
        r.deadline_at = r.submitted_at + r.deadline_s
    return r


def test_scheduler_strict_priority_order():
    s = Scheduler(max_admit=4)
    lo = [_req(prio=1) for _ in range(3)]
    hi = [_req(prio=0) for _ in range(3)]
    for r in lo + hi:
        s.enqueue(r)
    group = s.try_admit(free_slots=4, blocks_free=None)
    assert [r.priority for r in group] == [0, 0, 0, 1]
    assert group[3] is lo[0]


def test_scheduler_edf_within_tier():
    s = Scheduler(max_admit=8)
    plain_a = _stamp(_req())
    far = _stamp(_req(deadline_s=60.0))
    near = _stamp(_req(deadline_s=5.0))
    plain_b = _stamp(_req())
    for r in (plain_a, far, near, plain_b):
        s.enqueue(r)
    assert s.try_admit(free_slots=8, blocks_free=None) == \
        [near, far, plain_a, plain_b]


def test_scheduler_edf_is_fifo_without_deadlines():
    s = Scheduler(max_admit=8)
    reqs = [_stamp(_req()) for _ in range(5)]
    for r in reqs:
        s.enqueue(r)
    assert s.try_admit(free_slots=8, blocks_free=None) == reqs


def test_scheduler_edf_requeue_merges_by_deadline():
    s = Scheduler(max_admit=8)
    urgent = _stamp(_req(deadline_s=1.0))
    later = _stamp(_req(deadline_s=120.0))
    plain = _stamp(_req())
    for r in (later, plain):
        s.enqueue(r)
    s.requeue_front([urgent])
    assert s.try_admit(free_slots=8, blocks_free=None) == \
        [urgent, later, plain]


def test_scheduler_reserved_seats_beat_head_of_line_blocking():
    s = Scheduler(max_admit=4, tier_targets={1: 0.25})
    for _ in range(8):
        s.enqueue(_req(prio=0, size=8))
    starved = _req(prio=1, size=4)
    s.enqueue(starved)
    group = s.try_admit(free_slots=4, blocks_free=100,
                        need_for=lambda r: r.prompt_len)
    assert starved in group
    assert sum(1 for r in group if r.priority == 0) >= 1


def test_scheduler_strict_cap_floor_keeps_tier0_admissible():
    s = Scheduler(max_admit=2, tier_targets={1: 1.0})
    for _ in range(4):
        s.enqueue(_req(prio=1))
    head = _req(prio=0)
    s.enqueue(head)
    assert head in s.try_admit(free_slots=2, blocks_free=None)


def test_scheduler_queue_deadline_expires_typed():
    s = Scheduler(max_admit=4)
    events = []
    s.on_event = lambda kind, r: events.append((kind, r))
    r = _stamp(_req(deadline_s=0.01))
    s.enqueue(r)
    time.sleep(0.03)
    assert s.expire_waiting() == 1
    assert events == [("expired", r)]
    assert s.num_waiting == 0
    with pytest.raises(DeadlineExceeded):
        r.result(timeout=1.0)


def test_cancel_waiting_request_fails_immediately():
    s = Scheduler(max_admit=4)
    r = _req()
    s.enqueue(r)
    assert r.cancel() is True
    with pytest.raises(RequestCancelled):
        r.result(timeout=1.0)
    assert s.expire_waiting() == 1
    assert r.cancel() is False


# ---------------------------------------------------------- fault injector
def test_fault_injector_deterministic_schedule():
    spec = "grow_fail:p=0.3,seed=7;alloc_fail:every=3;chunk_latency:at=2,ms=5"
    a = FaultInjector.parse(spec)
    b = FaultInjector.parse(spec)
    sites = ("grow_fail", "alloc_fail", "chunk_latency")
    pat_a = [(site, a.fire(site)) for _ in range(50) for site in sites]
    pat_b = [(site, b.fire(site)) for _ in range(50) for site in sites]
    assert pat_a == pat_b
    assert a.counts() == b.counts()
    ca = a.counts()
    assert ca["alloc_fail"]["fires"] == 50 // 3
    assert ca["chunk_latency"]["fires"] == 1
    assert a.latency_s("chunk_latency") == pytest.approx(0.005)
    assert a.fire("preempt") is False


def test_fault_injector_spec_validation():
    with pytest.raises(ValueError):
        FaultInjector.parse("bogus_site")
    with pytest.raises(ValueError):
        FaultInjector.parse("grow_fail:p=0.5,at=3")
    with pytest.raises(ValueError):
        FaultInjector.parse("grow_fail;grow_fail")
    bare = FaultInjector.parse("preempt")
    assert bare.fire("preempt") is True
    assert bare.fire("preempt") is False


@pytest.mark.parametrize("spec", [
    BENIGN,
    "grow_fail:p=0.3,seed=7;alloc_fail:every=3;chunk_latency:at=2,ms=5",
    "preempt:every=4,n=3;evict:p=0.5;chunk_sync_exc:at=17",
    "crash_at:at=9;snapshot_corrupt;alloc_fail:p=0.9,seed=123,n=20",
    "grow_fail:every=1,n=7;preempt"])
def test_fault_injector_schedule_matches_reference(spec):
    ours, ref = FaultInjector.parse(spec), jfi.FaultInjector.parse(spec)
    assert SITES == jfi.SITES
    for _ in range(200):
        for site in jfi.SITES:
            assert ours.fire(site) == ref.fire(site), site
    assert ours.counts() == ref.counts()
    for site in jfi.SITES:
        assert ours.latency_s(site) == ref.latency_s(site)


@pytest.mark.parametrize("spec", [
    "bogus_site", "grow_fail:p=0.5,at=3", "grow_fail;grow_fail",
    "preempt:every", "preempt:foo=1", "alloc_fail:p=x", "evict:at=1,every=2",
    "chunk_latency:ms=1,,n=2"])
def test_fault_injector_rejects_what_the_reference_rejects(spec):
    with pytest.raises(Exception) as ref:
        jfi.FaultInjector.parse(spec)
    with pytest.raises(type(ref.value)):
        FaultInjector.parse(spec)


# ------------------------------------------------------------ load shedding
def test_submit_sheds_typed_overloaded(setup):
    cfg, tp = setup
    obs = Observability()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     shed_budget_s=0.05, obs=obs) as eng:
        # cold start: no service rate yet, the p90-queue-wait fallback
        # decides once 8 admissions are recorded
        assert eng._decode_rate == 0.0
        for _ in range(10):
            eng._mh["qwait"].record(1.0)
        with pytest.raises(Overloaded) as ei:
            eng.submit(P, max_new=4)
        assert ei.value.tier == 0
        assert ei.value.est_wait_s > ei.value.budget_s
        assert eng.stats["shed"] == 1
        assert obs.metrics.snapshot()["serve.shed"] == 1
        assert eng._scheduler.num_waiting == 0
        eng._shed_budget = {1: 0.05}      # a dict sheds its tiers only
        assert eng.result(eng.submit(P, max_new=4), 120.0).shape == (4,)
        # the service-rate model now outranks the stale histogram: an idle
        # engine has ~no queued work, so tier 1 is not shed
        assert eng._decode_rate > 0.0
        r = eng.submit(P, max_new=4, priority=1)
        assert eng.result(r, timeout=120.0).shape == (4,)
        long = eng.submit(P, max_new=400)
        eng._decode_rate = 100.0      # 400 queued tokens -> ~4s >> 0.05s
        with pytest.raises(Overloaded) as ei:
            eng.submit(P, max_new=4, priority=1)
        assert ei.value.est_wait_s > ei.value.budget_s
        r0 = eng.submit(P, max_new=4)        # tier 0: never shed
        assert eng.result(r0, timeout=120.0).shape == (4,)
        long.cancel()


def test_service_rate_estimator(setup):
    cfg, tp = setup
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2) as eng:
        assert eng._estimated_wait_s(0) is None
        eng._note_rate(20, 0.5)                      # 40 tok/s
        assert eng._decode_rate == pytest.approx(40.0)
        eng._note_rate(0, 1.0)                       # empty cycles skipped
        assert eng._decode_rate == pytest.approx(40.0)
        eng._scheduler.enqueue(ServeRequest([1, 2], 30, priority=0))
        eng._scheduler.enqueue(ServeRequest([1, 2], 50, priority=2))
        assert eng._estimated_wait_s(0) == pytest.approx(30 / 40.0)
        assert eng._estimated_wait_s(2) == pytest.approx(80 / 40.0)
        eng._scheduler.fail_all_waiting(RuntimeError("drain"))


def test_estimates_match_the_reference_engine():
    """The same service rate, resident mirrors and queue give the
    reference's wait estimates and hopeless verdicts."""
    cfg, jp, tp = _setup()
    with ServeEngine(cfg, tp, device="cpu", max_batch=4) as eng, \
            JEngine(cfg, jp, max_batch=4, paged_impl="gather") as jeng:
        for e, Req in ((eng, ServeRequest), (jeng, JRequest)):
            e._decode_rate = 37.5
            e._slot_req[1] = Req([1, 2], 8)
            e._slot_req[3] = Req([1, 2], 8)
            e._rem[1], e._rem[3], e._rem[2] = 11, 5, 99   # slot 2 empty
            e._stall_rem[3] = 7
            for prio, mn in ((0, 30), (1, 20), (2, 50)):
                e._scheduler.enqueue(Req([1, 2, 3], mn, priority=prio))
        for prio in (0, 1, 2, 3):
            assert eng._estimated_wait_s(prio) == pytest.approx(
                jeng._estimated_wait_s(prio))
        now = time.perf_counter()
        for dl, want_none in ((1e6, True), (0.0, False)):
            r = ServeRequest(np.arange(12, dtype=np.int32), 64,
                             deadline_s=1.0)
            jr = JRequest(np.arange(12, dtype=np.int32), 64, deadline_s=1.0)
            r.deadline_at = jr.deadline_at = now + dl
            a, b = eng._hopeless_why(r), jeng._hopeless_why(jr)
            assert (a is None) == (b is None) == want_none
            if a is not None:
                est = re.compile(r"prefill\+decode ([0-9.]+)s")
                assert est.search(a).group(1) == est.search(b).group(1)
        for e in (eng, jeng):
            e._slot_req[1] = e._slot_req[3] = None
            e._rem[:] = 0
            e._stall_rem[:] = 0
            e._scheduler.fail_all_waiting(RuntimeError("drain"))


# ------------------------------------------------ deadlines + cancel (engine)
@pytest.mark.parametrize("async_decode", [False, True])
def test_mid_decode_deadline_expiry_reclaims_row(setup, async_decode):
    cfg, tp = setup
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     async_decode=async_decode) as eng:
        eng.generate([P], max_new=3)
        r = eng.submit(P, max_new=64, deadline_s=0.05)
        with pytest.raises(DeadlineExceeded):
            eng.result(r, timeout=120.0)
        assert eng.stats["expired"] >= 1
        _wait_idle(eng)
        assert _pool_restored(eng)
        assert eng.generate([P], max_new=4)[0].tolist() == _solo(4)


@pytest.mark.parametrize("async_decode", [False, True])
def test_cancel_seated_request_reclaims_row(setup, async_decode):
    """The cancel repair: a decoding request's cancel() fails it typed,
    counts it, and its slot and every block come back."""
    cfg, tp = setup
    obs = Observability()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     async_decode=async_decode, obs=obs) as eng:
        eng.generate([P], max_new=3)
        r = eng.submit(P, max_new=200)
        deadline = time.time() + 30
        while r.state != "decoding" and time.time() < deadline:
            time.sleep(0.002)
        assert r.cancel() is True
        with pytest.raises(RequestCancelled):
            eng.result(r, timeout=120.0)
        assert eng.stats["cancelled"] == 1
        assert eng.stats["retired"] == 1          # the warm-up only
        _wait_idle(eng)
        assert _pool_restored(eng) and eng._pool.num_deferred == 0
        assert len(eng._free_slots) == len(eng._slot_req)
        assert obs.metrics.snapshot()["serve.cancelled"] == 1
        assert eng.generate([P], max_new=4)[0].tolist() == _solo(4)


@pytest.mark.parametrize("async_decode", [False, True])
def test_evicted_seat_tokens_never_reach_the_next_occupant(setup,
                                                           async_decode):
    """One slot: a request is cancelled mid-decode and the next one takes
    its seat at once (async: while a chunk computed for the old seat may
    be in flight); the newcomer's tokens are its solo run's."""
    cfg, tp = setup
    nxt = np.arange(7, 13, dtype=np.int32)
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2, max_batch=1,
                     async_decode=async_decode) as eng:
        want = eng.generate([nxt], max_new=12)[0].tolist()
        r = eng.submit(P, max_new=200)
        deadline = time.time() + 30
        while r.state != "decoding" and time.time() < deadline:
            time.sleep(0.002)
        r2 = eng.submit(nxt, max_new=12)
        assert r.cancel() is True
        with pytest.raises(RequestCancelled):
            eng.result(r, timeout=60.0)
        assert eng.result(r2, timeout=60.0).tolist() == want
        _wait_idle(eng)
        assert _pool_restored(eng) and eng._pool.num_deferred == 0


def test_cancel_queued_request_never_occupies_a_slot(setup):
    cfg, tp = setup
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     fault_inject="alloc_fail:every=1") as eng:
        r = eng.submit(P, max_new=4)
        assert r.cancel() is True
        with pytest.raises(RequestCancelled):
            eng.result(r, timeout=10.0)
        assert eng.stats["admitted"] == 0


# ------------------------------------------------------- failure isolation
@pytest.mark.parametrize("async_decode", [False, True])
def test_decode_fault_fails_rows_typed_engine_serves_on(setup,
                                                        async_decode):
    """``chunk_sync_exc`` fails only the seated rows, typed with the fault
    as ``__cause__``; the reset is in place (the chunk's tensors keep their
    addresses) and the engine serves on with the same tokens."""
    cfg, tp = setup
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     paged_impl="gather", async_decode=async_decode,
                     fault_inject="chunk_sync_exc:at=2") as eng:
        ptrs = eng._chunk._pointers()
        r = eng.submit(P, max_new=8)
        with pytest.raises(RowFailed) as ei:
            eng.result(r, timeout=120.0)
        assert isinstance(ei.value.__cause__, FaultInjected)
        assert eng._broken is None
        assert eng.stats["row_failures"] >= 1 and eng._reset_epoch == 1
        _wait_idle(eng)
        assert _pool_restored(eng)
        assert eng._chunk._pointers() == ptrs
        assert eng.generate([P], max_new=6)[0].tolist() == _solo(6)


@pytest.mark.parametrize("async_decode", [False, True])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_decode_fault_on_the_slot_pool_resets_in_place(arch, async_decode):
    """Isolation on the slot-state path: the failed rows fail typed, the
    slot state is zeroed in place (the chunk's tensors keep their
    addresses) and later requests emit a fresh engine's tokens."""
    cfg, _, tp = _setup(arch)
    kw = dict(decode_chunk=2, max_batch=2, max_seq_len=64,
              async_decode=async_decode)
    with ServeEngine(cfg, tp, device="cpu", **kw) as eng:
        want = [o.tolist() for o in eng.generate(SLOT_PROMPTS[:2], 8)]
    with ServeEngine(cfg, tp, device="cpu", fault_inject="chunk_sync_exc:at=2",
                     **kw) as eng:
        ptrs = eng._chunk._pointers()
        with pytest.raises(RowFailed):
            eng.result(eng.submit(SLOT_PROMPTS[2], 8), timeout=60.0)
        assert eng._broken is None and eng._reset_epoch == 1
        assert all(not t.any() for t in tengine._tensors(eng._sstate))
        got = [o.tolist() for o in eng.generate(SLOT_PROMPTS[:2], 8)]
        assert eng._chunk._pointers() == ptrs
        assert len(eng._free_slots) == 2 and not eng._inflight
    assert got == want


def test_prefill_failure_fails_only_its_group(setup, monkeypatch):
    cfg, tp = setup
    real = tengine.lm.prefill
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected prefill failure")
        return real(*a, **k)

    monkeypatch.setattr(tengine.lm, "prefill", flaky)
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     max_admit=1) as eng:
        bad = eng.submit(P, max_new=4)
        with pytest.raises(RowFailed) as ei:
            eng.result(bad, timeout=60.0)
        assert "injected prefill failure" in repr(ei.value.__cause__)
        assert eng.generate([P], max_new=4)[0].tolist() == _solo(4)
        assert eng.stats["row_failures"] == 1 and eng._reset_epoch == 0
        _wait_idle(eng)
        assert _pool_restored(eng)
        assert len(eng._free_slots) == len(eng._slot_req)


def test_benign_faults_keep_tokens_bit_identical_and_deterministic(setup):
    cfg, tp = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in (5, 9, 6, 7)]
    spec = "grow_fail:p=0.5,seed=13;preempt:at=3"

    def _run(fi):
        with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                         block_size=4, kv_blocks=32, paged_impl="gather",
                         fault_inject=fi) as eng:
            outs = eng.generate(prompts, max_new=10)
            return [o.tolist() for o in outs], \
                eng._fi.counts() if eng._fi is not None else None

    outs_a, counts_a = _run(spec)
    outs_b, counts_b = _run(spec)
    assert outs_a == outs_b
    for c in (counts_a, counts_b):
        assert c["preempt"]["fires"] == 1
        assert c["grow_fail"]["fires"] >= 1
        assert c["grow_fail"]["opportunities"] > 0
    assert outs_a == _run(None)[0]


# ------------------------------------------------------- watchdog + teardown
def test_watchdog_fails_futures_instead_of_hanging(setup):
    cfg, tp = setup
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2, watchdog_s=0.25,
                     fault_inject="chunk_latency:at=2,ms=3000") as eng:
        r = eng.submit(P, max_new=16)
        t0 = time.time()
        with pytest.raises(WatchdogTimeout):
            eng.result(r, timeout=30.0)
        assert time.time() - t0 < 2.5
        assert eng.stats["watchdog_fires"] == 1
        assert isinstance(eng._broken, WatchdogTimeout)
    assert eng._wd_thread is None


def test_close_fails_outstanding_typed_engine_closed(setup):
    cfg, tp = setup
    eng = ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                      fault_inject="alloc_fail:every=1")
    reqs = [eng.submit(P, max_new=4) for _ in range(3)]
    eng.close(timeout=0.5)
    for r in reqs:
        with pytest.raises(EngineClosed):
            r.result(timeout=5.0)


# ------------------------------------------------------------ SLO plumbing
def test_per_tier_ttft_histograms_and_counters(setup):
    cfg, tp = setup
    obs = Observability()
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2, obs=obs) as eng:
        r0 = eng.submit(P, max_new=4, priority=0)
        r2 = eng.submit(P, max_new=4, priority=2)
        eng.result(r0, timeout=120.0)
        eng.result(r2, timeout=120.0)
    h0 = obs.metrics.get("serve.ttft_s.tier0")
    h2 = obs.metrics.get("serve.ttft_s.tier2")
    assert h0 is not None and h0.count == 1
    assert h2 is not None and h2.count == 1
    assert r0.ttft is not None and r2.ttft is not None


def test_typed_errors_are_serve_errors():
    for klass in (Overloaded, DeadlineExceeded, RequestCancelled,
                  RowFailed, WatchdogTimeout, EngineClosed):
        assert issubclass(klass, ServeError)
    assert issubclass(DeadlineExceeded, TimeoutError)
    assert issubclass(WatchdogTimeout, TimeoutError)


def test_launcher_slo_flags_on_cpu(capsys):
    outs = launcher.main([
        "--device", "cpu", "--batch", "3", "--prompt-len", "6",
        "--max-new", "6", "--priority", "1", "--deadline", "60",
        "--tier-target", "1=0.5", "--shed-budget", "30", "--watchdog", "30",
        "--fault-inject", "alloc_fail:p=0.1,seed=1"])
    out = capsys.readouterr().out
    assert len(outs) == 3 and all(o.shape == (6,) for o in outs)
    assert "'shed': 0" in out and "sample:" in out
    outs = launcher.main(["--device", "cpu", "--batch", "2",
                          "--max-new", "64", "--deadline", "0.000001"])
    out = capsys.readouterr().out
    assert outs == [None, None]
    assert "failed: DeadlineExceeded" in out


# ------------------------------------------------------- parity with JAX
#: the benign trace: 24 prompts of 3-16 tokens (one window each), 9 new
#: tokens (two chunks of 4). ``preempt:every=5`` replays a paged row from
#: its prompt, so a row alone must finish within 4 cycles or it is
#: preempted forever (async adds a cycle of lag): the requests are sized
#: for that, in the reference as here
BENIGN_NEW = 9


def _trace_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, size=int(s)).astype(np.int32)
            for s in rng.integers(3, 17, size=24)]


@pytest.fixture(scope="module")
def jax_benign():
    """The JAX gather engine's tokens under the benign spec (once)."""
    cfg, jp, _ = _setup()
    with JEngine(cfg, jp, paged_impl="gather", fault_inject=BENIGN,
                 **GEOM) as eng:
        outs = eng.generate(_trace_prompts(cfg), max_new=BENIGN_NEW)
    return [o.tolist() for o in outs]


@pytest.mark.parametrize("async_decode", [False, True])
def test_benign_spec_tokens_match_jax_engine(jax_benign, async_decode):
    cfg, _, tp = _setup()
    prompts = _trace_prompts(cfg)
    runs = {}
    for fi in (None, BENIGN):
        with ServeEngine(cfg, tp, device="cpu", async_decode=async_decode,
                         fault_inject=fi, **GEOM) as eng:
            t = tally_discarded(eng)
            outs = eng.generate(prompts, max_new=BENIGN_NEW)
            runs[fi] = (outs, dict(eng.stats), t,
                        eng._fi.counts() if fi else None)
            assert _pool_restored(eng) and eng._pool.num_deferred == 0
    outs, stats, t, counts = runs[BENIGN]
    assert [o.tolist() for o in outs] == jax_benign
    assert [o.tolist() for o in runs[None][0]] == jax_benign
    # every site of the spec fired
    assert all(counts[s]["fires"] > 0 for s in counts), counts
    assert stats["preempted"] > 0
    # the exact window and growth invariants hold under the faults
    _, ref_stats, ref_t, _ = runs[None]
    check_stats(stats, ref_stats, outs, t, ref_t, GEOM["max_admit"])


SLOT_GEOM = dict(decode_chunk=2, max_seq_len=64, max_batch=2)
SLOT_PROMPTS = [np.arange(1, 8, dtype=np.int32),
                np.arange(3, 10, dtype=np.int32),
                np.arange(9, 16, dtype=np.int32)]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_slot_checkpoint_preemption_matches_jax(arch):
    """``preempt:every=3`` on a slot arch, sync: rows are checkpointed to
    host memory and re-seated exactly, with one prefill per request, and
    the tokens are the JAX engine's under the same spec."""
    cfg, jp, tp = _setup(arch)
    with JEngine(cfg, jp, fault_inject="preempt:every=3",
                 **SLOT_GEOM) as jeng:
        want = [o.tolist() for o in jeng.generate(SLOT_PROMPTS, 12)]
    with ServeEngine(cfg, tp, device="cpu", fault_inject="preempt:every=3",
                     **SLOT_GEOM) as eng:
        got = [o.tolist() for o in eng.generate(SLOT_PROMPTS, 12)]
        stats = dict(eng.stats)
        assert len(eng._free_slots) == SLOT_GEOM["max_batch"]
        assert all(r is None for r in eng._slot_req) and not eng._inflight
    assert got == want
    assert stats["preempted"] > 0
    assert stats["prefills"] == len(SLOT_PROMPTS)
    assert stats["admitted"] == len(SLOT_PROMPTS) + stats["preempted"]


def test_slot_boost_preempt_checkpoint_no_replay():
    """The sweep's admission boost on a full slot pool: a tier-0 arrival
    preempts a tier-1 row, which is checkpointed and resumes exactly."""
    cfg, _, tp = _setup("falcon-mamba-7b")
    with ServeEngine(cfg, tp, device="cpu", max_batch=4,
                     decode_chunk=2) as eng:
        ref = [o.tolist() for o in eng.generate(SLOT_PROMPTS, 24)]
    with ServeEngine(cfg, tp, device="cpu", max_batch=2,
                     decode_chunk=2) as eng:
        lo = [eng.submit(p, 24, priority=1) for p in SLOT_PROMPTS[:2]]
        deadline = time.time() + 30
        while not all(r.first_token_at for r in lo) \
                and time.time() < deadline:
            time.sleep(0.002)
        hi = eng.submit(SLOT_PROMPTS[2], 24, priority=0)
        outs = [eng.result(r, timeout=120.0).tolist() for r in lo + [hi]]
        stats = dict(eng.stats)
    assert stats["preempted"] > 0
    assert stats["prefills"] == len(SLOT_PROMPTS)
    assert outs == ref
