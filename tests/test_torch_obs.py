"""The port's observability (``repro_torch.obs``) against ``repro.obs``.

Unit layer: each scenario runs one call sequence through the reference
package and through the port's copy, and the two results (spans, drop
counts, percentiles, summaries, registry snapshots, the exported Chrome
trace JSON with both tracers on one origin, the stats line with its rate
column dropped) must be equal.

Engine layer, at float32 compute on the stablelm smoke config: the
port's sync engine on the CPU and the JAX engine on its ``gather`` oracle
serve the same requests with an ``Observability`` attached. Tokens must be
equal, and the scenarios of ``tests/test_obs.py`` are held on both: the
lifecycle spans (one queued/admitted chain and one retired instant per
request, cycle spans on the ``engine`` track, decode pipe bodies on
``lineN`` tracks), metrics that agree with the engine's own stats, the
exported trace's schema, and a preempted request's re-entry on its track.
"""
import dataclasses
import functools
import json
import math
import re
import threading
import time

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.params import from_reference
from repro_torch.serve.engine import ServeEngine

# ------------------------------------------------------------- unit layer
def _ring_wrap(m):
    tr = m.Tracer(capacity=8)
    for i in range(11):
        tr.add(f"s{i}", "t", float(i), float(i) + 0.5)
    log = [len(tr), tr.dropped, tr.spans()]
    tr.clear()
    return log + [len(tr), tr.dropped]


def _disabled(m):
    tr = m.Tracer(enabled=False)
    tr.add("a", "t", 0.0, 1.0)
    tr.instant("b", "t")
    with tr.span("c", "t"):
        pass
    log = [len(tr)]
    tr.enabled = True
    tr.add("a", "t", 0.0, 1.0)
    return log + [tr.spans()]


def _span_and_instant(m):
    tr = m.Tracer()
    with tr.span("work", "t", {"k": 1}):
        pass
    tr.instant("mark", "t")
    work, mark = tr.spans()
    t0 = tr.t0
    tr.clear()
    return [[s[0] for s in (work, mark)], work[3] >= work[2], work[4],
            mark[2] == mark[3], tr.t0 == t0]


def _threads(m):
    tr = m.Tracer(capacity=10_000)

    def burst(k):
        for _ in range(500):
            tr.add(f"w{k}", "t", 0.0, 1.0)

    threads = [threading.Thread(target=burst, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return [len(tr), tr.dropped,
            sorted((n, c) for n, c in _count(tr.spans()).items())]


def _count(spans):
    out = {}
    for s in spans:
        out[s[0]] = out.get(s[0], 0) + 1
    return out


def _counter_gauge(m):
    c = m.Counter("c")
    c.inc()
    c.inc(4)
    log = [c.value]
    c.reset()
    g = m.Gauge("g")
    g.set(7)
    g.inc(-2)
    return log + [c.value, g.value]


def _histogram_exact(m):
    h = m.Histogram("h")
    for i in range(1, 101):
        h.record(i / 1000.0)
    return [h.count, h.percentile(50), h.percentile(99), h.percentile(100),
            h.summary()]


def _histogram_buckets(m):
    h = m.Histogram("h", keep_samples=10)
    rng = np.random.default_rng(0)
    for v in rng.lognormal(mean=math.log(0.01), sigma=1.0, size=2000):
        h.record(float(v))
    return [h.percentile(50), h.percentile(99), h.summary(), h.growth]


def _histogram_validation(m):
    log = []
    try:
        m.Histogram("h", base=0.0)
    except ValueError as e:
        log.append(str(e))
    h = m.Histogram("h")
    log += [h.percentile(50), h.summary()]
    try:
        h.percentile(101)
    except ValueError as e:
        log.append(str(e))
    return log


def _registry(m):
    reg = m.MetricsRegistry()
    c = reg.counter("x")
    log = [reg.counter("x") is c]
    try:
        reg.gauge("x")
    except TypeError as e:
        log.append(str(e))
    h = reg.histogram("lat")
    c.inc(3)
    h.record(0.5)
    reg.gauge("q").set(2)
    log.append(reg.snapshot())
    reg.reset()
    return log + [c.value, h.count, reg.names(), reg.get("lat") is h]


def _export(m, tmp_path):
    tr = m.Tracer()
    tr.t0 = 100.0                    # one origin for both packages
    tr.add("cycle", m.TRACK_ENGINE, 100.001, 100.002)
    tr.add("decode", "slot0", 100.001, 100.003, {"req": 1})
    tr.add("decode", "slot10", 100.002, 100.004)
    tr.add("decode", "slot2", 100.002, 100.004)
    tr.add("decode", "line1", 100.002, 100.0035)
    tr.instant("retired", "slot0", 100.005, {"req": 1})
    reg = m.MetricsRegistry()
    reg.counter("serve.tokens_out").inc(42)
    reg.histogram("serve.ttft_s").record(0.25)
    path = str(tmp_path / f"{m.__name__}.json")
    m.export_chrome_trace(path, tr, reg)
    return [json.loads(open(path).read()), m.chrome_trace_events(tr)]


def _stats_logger(m):
    reg = m.MetricsRegistry()
    tok = reg.counter("serve.tokens_out")
    reg.gauge("serve.queue_depth").set(3)
    reg.histogram("serve.ttft_s").record(0.25)
    lines = []
    logger = m.StatsLogger(reg, interval=0.05, emit=lines.append)
    tok.inc(100)
    reg.counter("serve.requests.retired").inc(2)
    line = re.sub(r"tok/s +[0-9.]+", "tok/s R", logger.line())
    logger.start()
    log = [line]
    try:
        logger.start()
    except RuntimeError as e:
        log.append(str(e))
    time.sleep(0.2)
    logger.stop()
    logger.stop()
    try:
        m.StatsLogger(reg, interval=0.0)
    except ValueError as e:
        log.append(str(e))
    return log + [bool(lines)]


def _bundle_and_env(m, tmp_path, monkeypatch):
    obs = m.Observability(trace_capacity=16)
    obs.tracer.t0 = 5.0
    obs.tracer.add("a", "t", 5.1, 5.2)
    obs.metrics.counter("c").inc()
    path = obs.export(str(tmp_path / f"b_{m.__name__}.json"))
    log = [json.loads(open(path).read()), obs.tracer.capacity]
    obs.reset()
    log += [len(obs.tracer), obs.metrics.snapshot()]
    log += [m.env_enabled(v) for v in ("1", "TRUE", " on ", "", "0")]
    monkeypatch.delenv("REPRO_OBS", raising=False)
    log.append(m.from_env() is None)
    monkeypatch.setenv("REPRO_OBS", "1")
    log.append(type(m.from_env()).__name__)
    return log


UNIT = [_ring_wrap, _disabled, _span_and_instant, _threads, _counter_gauge,
        _histogram_exact, _histogram_buckets, _histogram_validation,
        _registry]


@pytest.mark.parametrize("scenario", UNIT,
                         ids=[f.__name__.strip("_") for f in UNIT])
def test_obs_matches_reference(scenario):
    assert scenario(tobs) == scenario(jobs)


def test_chrome_trace_export_matches_reference(tmp_path):
    got, ref = _export(tobs, tmp_path), _export(jobs, tmp_path)
    assert got == ref
    tracks = _validate_chrome_trace(got[0])
    ordered = [tracks[tid] for tid in sorted(tracks)]
    assert ordered == [tobs.TRACK_ENGINE, "line1", "slot0", "slot2",
                       "slot10"]


def test_stats_logger_matches_reference():
    got, ref = _stats_logger(tobs), _stats_logger(jobs)
    assert got == ref
    assert "queue 3" in got[0] and "ttft_p50 250ms" in got[0] and got[-1]


def test_observability_bundle_and_env_match_reference(tmp_path,
                                                      monkeypatch):
    assert _bundle_and_env(tobs, tmp_path, monkeypatch) \
        == _bundle_and_env(jobs, tmp_path, monkeypatch)


# ----------------------------------------------------------- engine layer
def _validate_chrome_trace(payload):
    """The trace-event schema ``tests/test_obs.py`` checks."""
    assert set(payload) >= {"traceEvents", "displayTimeUnit", "otherData"}
    assert payload["displayTimeUnit"] == "ms"
    assert {"spans", "dropped_spans"} <= set(payload["otherData"])
    tracks = {}
    for ev in payload["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
        assert ev["ph"] in ("M", "X", "i")
        if ev["ph"] == "M":
            if ev["name"] == "thread_name":
                tracks[ev["tid"]] = ev["args"]["name"]
        elif ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] > 0
        else:
            assert ev["s"] == "t" and "dur" not in ev
    events = payload["traceEvents"]
    assert sum(ev["ph"] in ("X", "i") for ev in events) \
        == payload["otherData"]["spans"]
    for ev in events:
        if ev["ph"] in ("X", "i"):
            assert ev["tid"] in tracks
    return tracks


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32")
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


def _engine(side, **kw):
    cfg, jp, tp = _setup()
    if side == "jax":
        return JEngine(cfg, jp, paged_impl="gather",
                       obs=jobs.Observability(), **kw)
    return ServeEngine(cfg, tp, device="cpu", obs=tobs.Observability(),
                       **kw)


def _lifecycle(side, tmp_path):
    """``tests/test_obs.py``'s lifecycle scenario; every check holds on
    the engine of ``side``. Returns the tokens and the span names."""
    cfg = _setup()[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in (4, 7, 4, 5)]
    max_new = 8
    with _engine(side, decode_chunk=4) as eng:
        obs = eng.obs
        t_run0 = time.perf_counter()
        reqs = [eng.submit(p, max_new) for p in prompts]
        outs = [eng.result(r, timeout=240.0) for r in reqs]
        wall = time.perf_counter() - t_run0
        for r in reqs:
            assert r.submitted_at <= r.admitted_at <= r.first_token_at \
                <= r.finished_at
            assert r.ttft == pytest.approx(r.first_token_at - r.submitted_at)
        by_name = {}
        for name, track, ts, te, args in obs.tracer.spans():
            assert te >= ts
            by_name.setdefault(name, []).append((track, ts, te, args))
        for required in ("queued", "admitted", "decode", "retired",
                         "admission", "cycle", "dispatch", "sync",
                         "bookkeeping", "growth"):
            assert required in by_name, f"missing {required} spans"
        for evt in ("queued", "admitted", "retired"):
            got = sorted(a["req"] for _, _, _, a in by_name[evt])
            assert got == sorted(r.id for r in reqs)
        assert all(t == "engine" for t, _, _, _ in by_name["cycle"])
        slot_decode = [(t, ts, te) for t, ts, te, _ in by_name["decode"]
                       if t.startswith("slot")]
        assert slot_decode
        assert all(t.startswith("line") for t, _, _, _ in by_name["decode"]
                   if not t.startswith("slot"))
        per_slot = {}
        for track, ts, te in slot_decode:
            per_slot[track] = per_slot.get(track, 0.0) + (te - ts)
        assert all(v <= wall for v in per_slot.values())
        snap = obs.metrics.snapshot()
        assert snap["serve.ttft_s"]["count"] == len(reqs)
        assert snap["serve.queue_wait_s"]["count"] == len(reqs)
        assert snap["serve.requests.admitted"] == len(reqs)
        assert snap["serve.requests.retired"] == len(reqs)
        assert snap["serve.tokens_out"] == eng.stats["tokens_out"]
        assert snap["engine.cycle_s"]["count"] == len(by_name["cycle"]) \
            == eng.stats["decode_cycles"]
        for h in ("engine.dispatch_s", "engine.chunk_sync_s",
                  "engine.book_s", "engine.chunk_s"):
            assert snap[h]["count"] == eng.stats["decode_cycles"]
        assert snap["serve.queue_depth"] == 0
        assert snap["serve.resident_rows"] == 0
        assert snap["pool.blocks_used"] == 0
        assert snap["pool.blocks_free"] == eng._pool.num_blocks - 1
        assert snap["serve.ttft_s"]["max"] <= wall
        path = str(tmp_path / f"{side}.json")
        obs.export(path)
    payload = json.loads(open(path).read())
    tracks = _validate_chrome_trace(payload).values()
    assert "engine" in tracks
    assert any(t.startswith("slot") for t in tracks)
    assert any(t.startswith("line") for t in tracks)
    assert payload["otherData"]["metrics"]["serve.requests.retired"] \
        == len(reqs)
    slot_names = sorted({n for n, v in by_name.items()
                         if any(t.startswith("slot") for t, *_ in v)})
    return [o.tolist() for o in outs], slot_names, set(snap)


def _preemption(side):
    cfg = _setup()[0]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(2)]
    with _engine(side, decode_chunk=4, kv_blocks=10, block_size=4) as eng:
        reqs = [eng.submit(p, max_new=16) for p in prompts]
        outs = [r.result(timeout=240.0) for r in reqs]
        stats = dict(eng.stats)
        snap = eng.obs.metrics.snapshot()
        spans = eng.obs.tracer.spans()
    assert stats["preempted"] >= 1
    assert stats["admitted"] == len(reqs) + stats["preempted"]
    assert snap["serve.requests.preempted"] == stats["preempted"]
    assert snap["serve.requests.admitted"] == stats["admitted"]
    assert snap["pool.grown_blocks"] == stats["grown_blocks"]
    pre = [a for n, _, _, _, a in spans if n == "preempted"]
    assert len(pre) == stats["preempted"]
    for vid in {a["req"] for a in pre}:
        admits = [1 for n, _, _, _, a in spans
                  if n == "admitted" and a["req"] == vid]
        assert len(admits) >= 2
        assert next(r for r in reqs if r.id == vid).preempted_count >= 1
    assert snap["serve.ttft_s"]["count"] == len(reqs)
    return [o.tolist() for o in outs]


def test_engine_lifecycle_spans_and_metric_consistency(tmp_path):
    ref_outs, ref_names, ref_metrics = _lifecycle("jax", tmp_path)
    outs, names, metrics = _lifecycle("torch", tmp_path)
    assert outs == ref_outs
    assert names == ref_names
    # the port binds what the reference binds: the SLO, failure and
    # recovery counters included
    assert metrics == ref_metrics
    assert {"serve.shed", "serve.expired", "serve.cancelled",
            "serve.watchdog_fires", "serve.row_failures",
            "serve.recovered", "serve.replayed_tokens"} <= metrics


def test_preemption_reentry_visible_in_trace():
    assert _preemption("torch") == _preemption("jax")


def test_set_obs_rebinds_and_disabled_path_records_nothing():
    cfg, _, tp = _setup()
    obs = tobs.Observability()
    prompt = np.arange(1, 6, dtype=np.int32)
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=4) as eng:
        assert eng.obs is None and eng._mh is None
        base = eng.generate([prompt], max_new=6)[0]
        eng.set_obs(obs)
        assert eng._pipeline.tracer is obs.tracer
        out = eng.generate([prompt], max_new=6)[0]
        n = len(obs.tracer)
        eng.set_obs(None)
        assert eng._pipeline.tracer is None
        again = eng.generate([prompt], max_new=6)[0]
    assert base.tolist() == out.tolist() == again.tolist()
    assert n > 0 and len(obs.tracer) == n
    assert obs.metrics.snapshot()["serve.ttft_s"]["count"] == 1


def test_obs_env_and_slot_engine_spans(monkeypatch):
    """``REPRO_OBS`` turns observability on; the slot-state engine
    (falcon-mamba) records the same lifecycle."""
    import torch
    from repro_torch.params import init_params
    monkeypatch.setenv("REPRO_OBS", "1")
    cfg = get_config("falcon-mamba-7b").smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with ServeEngine(cfg, params, device="cpu", decode_chunk=4) as eng:
        assert isinstance(eng.obs, tobs.Observability)
        reqs = [eng.submit(np.arange(1, 6, dtype=np.int32), 6)
                for _ in range(3)]
        [r.result(timeout=120) for r in reqs]
        names = {s[0] for s in eng.obs.tracer.spans()}
        snap = eng.obs.metrics.snapshot()
    assert {"queued", "admitted", "decode", "retired", "cycle"} <= names
    assert snap["serve.ttft_s"]["count"] == 3
    assert snap["serve.requests.retired"] == 3
