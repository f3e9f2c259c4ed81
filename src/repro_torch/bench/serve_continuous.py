"""Continuous-batching serve suite: tokens/sec and latency percentiles under
a Poisson arrival trace, and the prefix-cache workload.

The port of ``benchmarks/serve_continuous.py`` (``bench`` and
``bench_prefix_share``; not a paper figure). One resident ``ServeEngine``
takes each arrival by ``submit()`` at its trace time, with a live
:class:`repro_torch.obs.Observability`: every percentile row is read back
from the metrics registry (exact nearest-rank percentiles up to 4,096
samples), TTFT from the engine's own ``serve.ttft_s`` histogram, and
``trace_path`` receives the run's Chrome trace-event JSON.

Prompt-length distributions (``prompt_dist``): ``choice`` (16, 24 or 32
tokens; 8 or 12 with ``quick``) or ``lognormal`` (a heavy tail quantized
to multiples of 4). Reported: tokens/sec, request latency p50/p99 (nominal
arrival to result), admission latency p50/p99 (nominal arrival to first
admission), TTFT p50/p99, the engine's admission / cycle / growth counts
and the mean decode cycle split into host enqueue (``engine.dispatch_s``),
the wait at the chunk's token read-back (``engine.chunk_sync_s``), host
bookkeeping (``engine.book_s``) and the part of the cycle with no chunk in
flight (``engine.gap_s``).

``bench_prefix_share`` swaps in the prefix-cache workload: 4 prefixes of
96 tokens crossed with 4-8-token suffixes, replayed over one trace cold
(cache off) and warm (cache on; the warm-up bursts seed the cache).
Reported: hit rate, prefill tokens saved, copy-on-write forks and warm-
against-cold admission and TTFT p50/p99.

The per-call baseline (``serve_percall_*`` rows and the ``x_per_call``
derived columns of the continuous rows, as in the reference): a second
engine serves the same trace through ``ServeEngine._generate_grouped``,
one call per request, serially, each arrival-to-completion latency counted
from its nominal arrival. The reference jits its per-call decode chunk; the
port's runs it eagerly, so on the card the baseline is host-bound and
``x_per_call`` overstates the resident engine's advantage.
``arch``/``preset`` choose the model (the smoke
config by default, as in the reference; ``preset="full"`` runs it at full
width with random weights drawn from ``seed``), ``n_req`` the trace length
and ``device`` where it runs (None means CUDA).
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

PROMPT_DISTS = ("choice", "lognormal")


def _sample_lens(rng, n: int, dist: str, quick: bool):
    if dist == "lognormal":
        cap = 32 if quick else 64
        raw = rng.lognormal(mean=np.log(10.0), sigma=0.8, size=n)
        return np.clip((np.ceil(raw / 4) * 4).astype(int), 4, cap)
    lens = (8, 12) if quick else (16, 24, 32)
    return np.asarray([int(rng.choice(lens)) for _ in range(n)])


def _trace(rng, sizes, rate_hz: float, max_new: int):
    """Poisson arrivals: (arrival_time, prompt, max_new) tuples."""
    t = 0.0
    out = []
    for size in sizes:
        t += rng.exponential(1.0 / rate_hz)
        prompt = rng.integers(0, 500, size=int(size)).astype("int32")
        out.append((t, prompt, max_new))
    return out


def load_model(arch: str = "stablelm-1.6b", preset: str = "smoke",
               device=None, seed: int = 0):
    """(cfg, params, device): the config at ``preset`` and random weights
    from a seeded ``torch.Generator`` on ``device`` (None means CUDA)."""
    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..params import init_params
    dev = resolve_device(device)
    cfg = get_config(arch)
    if preset == "smoke":
        cfg = cfg.smoke()
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
    return cfg, params, dev


def _replay(eng, trace, obs) -> Tuple[list, list, float]:
    """Submit each arrival at its trace time; record latency and admission
    latency into registry histograms. Returns (requests, their tokens,
    seconds)."""
    h_lat = obs.metrics.histogram("bench.request_latency_s")
    h_adm = obs.metrics.histogram("bench.admission_latency_s")
    t0 = time.perf_counter()
    reqs = []
    for at, prompt, mn in trace:
        now = time.perf_counter() - t0
        if now < at:
            time.sleep(at - now)
        reqs.append((at, eng.submit(prompt, mn)))
    outs = []
    for at, r in reqs:
        outs.append(eng.result(r, timeout=600.0))
        h_lat.record(r.finished_at - t0 - at)
        h_adm.record(max(0.0, r.admitted_at - t0 - at))
    return [r for _, r in reqs], outs, time.perf_counter() - t0


def _reset(eng, obs) -> None:
    """Zero the engine's stats and the registry in place at idle (metric
    handles the engine cached stay valid)."""
    for k in eng.stats:
        eng.stats[k] = 0
    obs.reset()


def continuous_engine(cfg, params, trace, *, chunk: int = 8, impl=None,
                      device=None, **engine_kw):
    """The engine :func:`continuous_run` serves ``trace`` with (and its
    ``Observability``), warmed up: one request per power-of-two window
    bucket, then one saturating mixed-length burst (the reference's
    warm-up; here it warms the allocator and the library handles rather
    than compiles). ``engine_kw`` goes to ``ServeEngine`` (e.g.
    ``async_decode``, ``chunk_graph``)."""
    from ..obs import Observability
    from ..serve.engine import ServeEngine

    bs = 8
    lens = [len(p) for _, p, _ in trace]
    max_new = max(mn for _, _, mn in trace)
    max_seq = -(-(max(lens) + max_new) // bs) * bs
    obs = Observability()
    eng = ServeEngine(cfg, params, decode_chunk=chunk, block_size=bs,
                      max_seq_len=max_seq, kv_blocks=128,
                      prefill_chunk=2 * bs, paged_impl=impl, obs=obs,
                      device=device, **engine_kw)
    buckets = {1 << max(0, s - 1).bit_length(): s for s in sorted(lens)}
    for s in buckets.values():
        eng.generate([next(p for _, p, _ in trace if len(p) == s)],
                     max_new=chunk + 1)
    eng.generate([p for _, p, _ in trace], max_new=chunk + 1)
    return eng, obs


def measured_run(eng, obs, trace, trace_path: Optional[str] = None) -> dict:
    """One measured replay of ``trace`` on a warmed engine (stats and the
    registry zeroed first). Returns what :func:`continuous_run` does."""
    _reset(eng, obs)
    reqs, outs, dt = _replay(eng, trace, obs)
    # the complete stage records its last spans after the futures are
    # fulfilled: the stats and the trace are read once the pipeline rests
    limit = time.perf_counter() + 60.0
    while eng._pipeline is not None and not eng._pipeline.idle() \
            and time.perf_counter() < limit:
        time.sleep(0.001)
    stats = dict(eng.stats)
    if trace_path:
        obs.export(trace_path)
    return {"eng": eng, "obs": obs, "reqs": reqs, "outs": outs,
            "stats": stats, "dt": dt, "impl": eng.paged_impl}


def continuous_run(cfg, params, trace, *, chunk: int = 8, impl=None,
                   device=None, trace_path: Optional[str] = None,
                   **engine_kw) -> dict:
    """The continuous mode over ``trace``: warm-up, then the measured
    replay. Returns the closed engine, its ``Observability``, the
    requests, their tokens, the stats and the wall seconds."""
    eng, obs = continuous_engine(cfg, params, trace, chunk=chunk, impl=impl,
                                 device=device, **engine_kw)
    with eng:
        return measured_run(eng, obs, trace, trace_path)


def percall_run(cfg, params, trace, *, chunk: int = 8, device=None
                ) -> dict:
    """The per-call baseline over ``trace``: an engine of the reference's
    default geometry warmed once per distinct prompt length, then one
    ``_generate_grouped`` call per arrival, serially, at its trace time.
    Returns the tokens, the p50 and p99 of each request's latency from its
    nominal arrival (``np.percentile``, as the reference) and the wall
    seconds."""
    from ..serve.engine import ServeEngine

    lat, outs = [], []
    with ServeEngine(cfg, params, decode_chunk=chunk, device=device) as base:
        for s in sorted({len(p) for _, p, _ in trace}):
            p, mn = next((p, mn) for _, p, mn in trace if len(p) == s)
            base._generate_grouped([p], mn)
        t0 = time.perf_counter()
        for at, prompt, mn in trace:
            now = time.perf_counter() - t0
            if now < at:
                time.sleep(at - now)
            outs.append(base._generate_grouped([prompt], mn)[0])
            lat.append(time.perf_counter() - t0 - at)
        dt = time.perf_counter() - t0
    return {"outs": outs, "dt": dt, "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99))}


def _ms(h, q) -> str:
    return f"{h.percentile(q) * 1e3:.0f}"


def continuous_rows(run: dict, sizes, prompt_dist: str,
                    base: Optional[dict] = None
                    ) -> Iterator[Tuple[str, str, str]]:
    """The continuous rows; with ``base`` (:func:`percall_run`) the
    ``x_per_call`` derived columns and the ``serve_percall_*`` rows, in the
    reference's order."""
    m = run["obs"].metrics
    st = run["stats"]
    n_req = len(run["reqs"])
    tokens = sum(len(o) for o in run["outs"])
    lat = m.get("bench.request_latency_s")
    adm = m.get("bench.admission_latency_s")
    ttft = m.get("serve.ttft_s").summary()
    x = {"tok": f"{n_req}_requests", 50: "", 99: ""}
    if base is not None:
        x["tok"] = f"{base['dt'] / run['dt']:.2f}x_per_call"
        for q in (50, 99):
            x[q] = f"{base[f'p{q}'] / max(lat.percentile(q), 1e-9):.2f}" \
                "x_per_call"
    yield ("serve_continuous_tok_per_s", f"{tokens / run['dt']:.1f}",
           x["tok"])
    yield ("serve_continuous_paged_impl", run["impl"], "")
    yield ("serve_prompt_dist", prompt_dist,
           f"lens_{int(min(sizes))}_{int(max(sizes))}")
    yield ("serve_continuous_p50_ms", _ms(lat, 50), x[50])
    yield ("serve_continuous_p99_ms", _ms(lat, 99), x[99])
    yield ("serve_admission_p50_ms", _ms(adm, 50), "")
    yield ("serve_admission_p99_ms", _ms(adm, 99), "")
    yield ("serve_ttft_p50_ms", f"{ttft['p50'] * 1e3:.0f}",
           f"count_{ttft['count']}")
    yield ("serve_ttft_p99_ms", f"{ttft['p99'] * 1e3:.0f}", "")
    if base is not None:
        btok = sum(len(o) for o in base["outs"])
        yield ("serve_percall_tok_per_s", f"{btok / base['dt']:.1f}", "")
        yield ("serve_percall_p50_ms", f"{base['p50'] * 1e3:.0f}", "")
        yield ("serve_percall_p99_ms", f"{base['p99'] * 1e3:.0f}", "")
    yield ("serve_continuous_admits", str(st["admitted"]),
           f"{st['prefills']}_prefill_launches")
    yield ("serve_continuous_decode_cycles", str(st["decode_cycles"]),
           f"{st['admit_parks']}_admit_parks")
    yield ("serve_continuous_growth", str(st["grown_blocks"]),
           f"{st['preempted']}_preemptions_"
           f"{st['prefill_windows']}_windows")
    cyc = {k: m.get(f"engine.{k}_s").summary()
           for k in ("cycle", "dispatch", "chunk_sync", "book", "gap")}
    yield ("serve_cycle_mean_ms", f"{cyc['cycle']['mean'] * 1e3:.3f}",
           f"dispatch_{cyc['dispatch']['mean'] * 1e3:.3f}_"
           f"sync_{cyc['chunk_sync']['mean'] * 1e3:.3f}_"
           f"book_{cyc['book']['mean'] * 1e3:.3f}_"
           f"gap_{cyc['gap']['mean'] * 1e3:.3f}_ms")
    yield ("serve_trace_spans", str(len(run["obs"].tracer)),
           f"{run['obs'].tracer.dropped}_dropped")


def bench(quick: bool = False, impl: Optional[str] = None,
          prompt_dist: str = "choice", trace_path: Optional[str] = None,
          arch: str = "stablelm-1.6b", preset: str = "smoke", device=None,
          n_req: Optional[int] = None) -> Iterator[Tuple[str, str, str]]:
    """The continuous rows against the per-call baseline. ``impl`` is the
    paged read path (None: the engine's default, K1 on CUDA)."""
    if prompt_dist not in PROMPT_DISTS:
        raise ValueError(f"prompt_dist={prompt_dist!r}: expected one of "
                         f"{PROMPT_DISTS}")
    cfg, params, dev = load_model(arch, preset, device)
    n_req = n_req or (8 if quick else 32)
    max_new = 8 if quick else 32
    chunk = 4 if quick else 8
    # an arrival rate above the service rate: continuous batching is a
    # mechanism for overlapping requests
    rate = 200.0 if quick else 20.0
    rng = np.random.default_rng(0)
    sizes = _sample_lens(rng, n_req, prompt_dist, quick)
    trace = _trace(rng, sizes, rate, max_new)
    run = continuous_run(cfg, params, trace, chunk=chunk, impl=impl,
                         device=dev, trace_path=trace_path)
    base = percall_run(cfg, params, trace, chunk=chunk, device=dev)
    yield from continuous_rows(run, sizes, prompt_dist, base)


def prefix_share_trace(quick: bool = False, n_req: Optional[int] = None
                       ) -> Tuple[list, dict]:
    """Long shared prefixes crossed with short unique suffixes under
    Poisson arrivals, and the workload's geometry."""
    n_req = n_req or (8 if quick else 24)
    max_new = 4 if quick else 16
    n_prefix = 2 if quick else 4
    prefix_len = 48 if quick else 96
    rate = 200.0 if quick else 20.0
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 500, size=prefix_len).astype("int32")
                for _ in range(n_prefix)]
    t, trace = 0.0, []
    for i in range(n_req):
        t += rng.exponential(1.0 / rate)
        suffix = rng.integers(0, 500, size=int(rng.integers(4, 9))
                              ).astype("int32")
        trace.append((t, np.concatenate([prefixes[i % n_prefix], suffix]),
                      max_new))
    # the pool makes admission BLOCK-limited: cold admissions budget the
    # whole prompt, warm ones only the unique suffix
    geom = {"chunk": 4 if quick else 8, "kv_blocks": 28 if quick else 80,
            "n_prefix": n_prefix, "prefix_len": prefix_len}
    return trace, geom


def prefix_share_run(cfg, params, trace, geom: dict, prefix_cache: bool, *,
                     impl=None, device=None,
                     trace_path: Optional[str] = None, **engine_kw) -> dict:
    """One pass of the prefix-share trace: two saturating warm-up bursts
    (the second runs against the seeded cache when it is on), then the
    measured replay. Returns what :func:`continuous_run` returns;
    ``engine_kw`` goes to ``ServeEngine``."""
    from ..obs import Observability
    from ..serve.engine import ServeEngine

    bs = 8
    chunk = geom["chunk"]
    max_new = max(mn for _, _, mn in trace)
    max_seq = -(-(max(len(p) for _, p, _ in trace) + max_new) // bs) * bs
    obs = Observability()
    eng = ServeEngine(cfg, params, decode_chunk=chunk, block_size=bs,
                      max_seq_len=max_seq, kv_blocks=geom["kv_blocks"],
                      prefill_chunk=2 * bs, paged_impl=impl,
                      prefix_cache=prefix_cache, obs=obs, device=device,
                      **engine_kw)
    with eng:
        for _ in range(2):
            eng.generate([p for _, p, _ in trace], max_new=chunk + 1)
        _reset(eng, obs)
        reqs, outs, dt = _replay(eng, trace, obs)
        stats = dict(eng.stats)
        if trace_path:
            obs.export(trace_path)
    return {"eng": eng, "obs": obs, "reqs": reqs, "outs": outs,
            "stats": stats, "dt": dt, "impl": eng.paged_impl}


def prefix_share_rows(cold: dict, warm: dict, geom: dict
                      ) -> Iterator[Tuple[str, str, str]]:
    st = warm["stats"]
    tokens = sum(len(o) for o in warm["outs"])
    mc, mw = cold["obs"].metrics, warm["obs"].metrics
    ac, aw = (m.get("bench.admission_latency_s") for m in (mc, mw))
    tc, tw = (m.get("serve.ttft_s") for m in (mc, mw))
    hit_rate = st["prefix_hits"] / max(1, st["admitted"])
    yield ("serve_prefix_hit_rate", f"{hit_rate:.3f}",
           f"{st['prefix_hits']}_of_{st['admitted']}_admissions")
    yield ("serve_prefix_tokens_saved", str(st["prefix_tokens_saved"]),
           f"{st['cow_forks']}_cow_forks")
    yield ("serve_prefix_tok_per_s", f"{tokens / warm['dt']:.1f}",
           f"{cold['dt'] / warm['dt']:.2f}x_cold")
    for q in (50, 99):
        yield (f"serve_prefix_admission_p{q}_ms", _ms(aw, q),
               f"cold_{_ms(ac, q)}ms")
    for q in (50, 99):
        yield (f"serve_prefix_ttft_p{q}_ms", _ms(tw, q),
               f"cold_{_ms(tc, q)}ms")
    yield ("serve_prefix_workload",
           f"{geom['n_prefix']}x{geom['prefix_len']}_prefixes",
           warm["impl"])
    yield ("serve_cold_admission_p50_ms", _ms(ac, 50), "")
    yield ("serve_cold_ttft_p50_ms", _ms(tc, 50), "")


def bench_prefix_share(quick: bool = False, impl: Optional[str] = None,
                       trace_path: Optional[str] = None,
                       arch: str = "stablelm-1.6b", preset: str = "smoke",
                       device=None, n_req: Optional[int] = None
                       ) -> Iterator[Tuple[str, str, str]]:
    """The prefix-share rows: the identical trace cold, then warm; the
    warm pass writes ``trace_path``."""
    cfg, params, dev = load_model(arch, preset, device)
    trace, geom = prefix_share_trace(quick, n_req)
    cold = prefix_share_run(cfg, params, trace, geom, False, impl=impl,
                            device=dev)
    warm = prefix_share_run(cfg, params, trace, geom, True, impl=impl,
                            device=dev, trace_path=trace_path)
    yield from prefix_share_rows(cold, warm, geom)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--impl", default=None,
                    choices=("kernel", "loop", "gather"),
                    help="paged read path of the engine")
    ap.add_argument("--prompt-dist", default="choice", choices=PROMPT_DISTS)
    ap.add_argument("--prefix-share", action="store_true",
                    help="run the shared-prefix workload (cold vs warm "
                         "prefix cache over one trace) instead")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's Chrome trace-event JSON here")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--n-req", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the plain versions")
    args = ap.parse_args(argv)
    kw = dict(quick=args.quick, impl=args.impl, trace_path=args.trace,
              arch=args.arch, preset=args.preset, device=args.device,
              n_req=args.n_req)
    rows = bench_prefix_share(**kw) if args.prefix_share \
        else bench(prompt_dist=args.prompt_dist, **kw)
    for name, val, derived in rows:
        print(f"{name},{val},{derived}", flush=True)


if __name__ == "__main__":
    main()
