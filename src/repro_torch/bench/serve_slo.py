"""SLO overload suite: tier-0 tail TTFT under best-effort saturation, with
overload control.

The port of ``benchmarks/serve_slo.py`` (not a paper figure), with its
trace generator, seeds, rates, deadlines, budgets, ``max_batch=2`` and row
names. Two runs over seeded traces on ONE resident engine:

* ``uncontended`` — the tier-0 (SLO) trace alone: sparse Poisson arrivals
  of short prompts; its TTFT p99 is what the SLO is measured against;
* ``contended`` — the same tier-0 arrivals interleaved with a tier-1
  best-effort flood (near-simultaneous heavy-tailed lognormal prompts,
  short deadlines, a small tier-1 shed budget). Offered load exceeds the
  service rate, so the overload controls do the work: shedding at submit
  (typed ``Overloaded``), deadline expiry, tier-aware admission
  (``tier_targets``) and cost-model preemption that spares tier-0 rows.

Reported: tier-0 TTFT p50/p99 of both runs and the contended/uncontended
p99 ratio (the target is <= 2x, reported and not asserted, as in the
reference), the shed / expired / preempted counts and the tier-1
completion breakdown. Percentiles are read from the engine's per-tier
``serve.ttft_s.tier{N}`` histograms; nonzero ``shed + expired`` in the
contended run is what separates "survived by controlling load" from
"survived because load was light".

``arch``/``preset``/``device`` as in :mod:`repro_torch.bench.serve_continuous`
(the smoke config by default, as the reference; ``preset="full"`` runs at
full width with random weights from a seed); ``engine_kw`` goes to the
engine (``async_decode``, ``chunk_graph``). :func:`slo_engine`,
:func:`slo_run` and :func:`slo_rows` are the pieces ``chip_smoke.py``
drives with weights it already holds.
"""
from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np


def _mk_trace(rng, n: int, rate_hz: float, lens, max_new: int,
              priority: int, deadline_s):
    """Poisson arrivals: (t, prompt, max_new, priority, deadline) rows."""
    t, out = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / rate_hz)
        size = int(lens[i % len(lens)]) if hasattr(lens, "__len__") \
            else int(lens)
        prompt = rng.integers(0, 500, size=size).astype(np.int32)
        out.append((t, prompt, max_new, priority, deadline_s))
    return out


def slo_workload(quick: bool = False) -> dict:
    """The reference's traces and engine geometry: ``t0`` (tier-0 alone),
    ``merged`` (tier 0 and the tier-1 flood) and the engine arguments."""
    chunk = 4 if quick else 8
    bs = 8
    n0 = 6 if quick else 12              # tier-0 (SLO) requests
    n1 = 60 if quick else 72             # tier-1 best-effort flood
    max_new0 = 8 if quick else 16
    # tier-1 decodes long: its offered work must exceed what the narrow
    # batch serves inside the arrival window
    max_new1 = 64
    rate0 = 2.0                          # tier 0 alone must not saturate
    rate1 = 60.0                         # the flood arrives compressed
    # tighter than a queued tier-1 request's wait under saturation
    tier1_deadline = 0.15 if quick else 2.0
    max_batch = 2                        # a narrow engine: the overload
    rng = np.random.default_rng(0)
    lens0 = (8, 12) if quick else (12, 16, 24)
    cap = 32 if quick else 64
    raw = rng.lognormal(mean=np.log(12.0), sigma=0.8, size=n1)
    lens1 = np.clip((np.ceil(raw / 4) * 4).astype(int), 4, cap)
    t0_trace = _mk_trace(rng, n0, rate0, lens0, max_new0,
                         priority=0, deadline_s=None)
    t1_trace = _mk_trace(rng, n1, rate1, lens1, max_new1,
                         priority=1, deadline_s=tier1_deadline)
    merged = sorted(t0_trace + t1_trace, key=lambda r: r[0])
    max_len = max(len(p) for _, p, _, _, _ in merged)
    max_seq = -(-(max_len + max(max_new0, max_new1)) // bs) * bs
    engine = dict(decode_chunk=chunk, block_size=bs, max_seq_len=max_seq,
                  kv_blocks=48 if quick else 64, max_batch=max_batch,
                  max_admit=max_batch, prefill_chunk=2 * bs,
                  tier_targets={1: 0.25},
                  # looser than the deadline, so the shed gate's limit IS
                  # the deadline (the min of the two)
                  shed_budget_s={1: 0.3 if quick else 0.5})
    return {"t0": t0_trace, "merged": merged, "engine": engine,
            "n0": n0, "n1": n1, "tier1_deadline": tier1_deadline}


def slo_engine(cfg, params, work: dict, device=None, **engine_kw):
    """The suite's engine (and its ``Observability``), warmed up as the
    reference warms it: one request per power-of-two window bucket, then
    one saturating burst of every prompt."""
    from ..obs import Observability
    from ..serve.engine import ServeEngine
    merged = work["merged"]
    chunk = work["engine"]["decode_chunk"]
    obs = Observability()
    eng = ServeEngine(cfg, params, device=device, obs=obs,
                      **work["engine"], **engine_kw)
    distinct = sorted({len(p) for _, p, _, _, _ in merged})
    buckets = {1 << max(0, s - 1).bit_length(): s for s in distinct}
    for s in buckets.values():
        warm = [p for _, p, _, _, _ in merged if len(p) == s][:1]
        if warm:
            eng.generate(warm, max_new=chunk + 1)
    eng.generate([p for _, p, _, _, _ in merged], max_new=chunk + 1)
    return eng, obs


def slo_run(eng, obs, trace) -> dict:
    """Replay ``trace`` at its arrival times on a warmed engine (stats and
    registry zeroed in place first). Returns the TTFT summaries, the
    completion counts, each submitted request's outcome (tokens or the
    typed error) and the engine's stats."""
    from ..serve.errors import ServeError
    from .serve_continuous import settle
    for k in eng.stats:
        eng.stats[k] = 0
    obs.reset()
    t_start = time.perf_counter()
    pending, submit_errs = [], 0
    for at, prompt, mn, prio, dl in trace:
        now = time.perf_counter() - t_start
        if now < at:
            time.sleep(at - now)
        try:
            pending.append(eng.submit(prompt, max_new=mn, priority=prio,
                                      deadline_s=dl))
        except ServeError:
            submit_errs += 1               # Overloaded: shed at the door
    done, failed, outcomes = 0, 0, []
    for r in pending:
        try:
            outcomes.append((r, eng.result(r, timeout=600.0)))
            done += 1
        except ServeError as e:
            outcomes.append((r, e))        # expired / cancelled / failed
            failed += 1
    dt = time.perf_counter() - t_start
    settle(eng)      # the last spans and stats land after the last result
    h0 = obs.metrics.get("serve.ttft_s.tier0")
    h1 = obs.metrics.get("serve.ttft_s.tier1")
    return {"dt": dt, "ttft0": h0.summary() if h0 is not None else None,
            "ttft1": h1.summary() if h1 is not None else None,
            "done": done, "failed": failed, "shed": submit_errs,
            "outcomes": outcomes, "stats": dict(eng.stats)}


def slo_rows(base: dict, cont: dict, work: dict,
             trace_path: Optional[str] = None, obs=None
             ) -> Iterator[Tuple[str, str, str]]:
    """The reference suite's rows from an uncontended and a contended
    run."""
    b99 = base["ttft0"]["p99"]
    c99 = cont["ttft0"]["p99"]
    ratio = c99 / max(b99, 1e-9)
    st = cont["stats"]
    yield ("serve_slo_tier0_ttft_p99_ms", f"{c99*1e3:.0f}",
           f"{ratio:.2f}x_uncontended")
    yield ("serve_slo_tier0_ttft_p50_ms",
           f"{cont['ttft0']['p50']*1e3:.0f}",
           f"uncontended_{base['ttft0']['p50']*1e3:.0f}ms")
    yield ("serve_slo_uncontended_p99_ms", f"{b99*1e3:.0f}",
           f"count_{base['ttft0']['count']}")
    yield ("serve_slo_within_2x", str(ratio <= 2.0),
           "acceptance_target_reported_not_asserted")
    yield ("serve_slo_shed", str(st["shed"]),
           f"{cont['shed']}_submit_rejections")
    yield ("serve_slo_expired", str(st["expired"]),
           f"deadline_{work['tier1_deadline']:.1f}s")
    yield ("serve_slo_preempted", str(st["preempted"]),
           f"{st['stalls']}_stalls")
    yield ("serve_slo_completed", str(cont["done"]),
           f"of_{work['n0'] + work['n1']}_offered_{cont['failed']}"
           f"_failed_typed")
    if cont["ttft1"] is not None and cont["ttft1"]["count"]:
        yield ("serve_slo_tier1_ttft_p50_ms",
               f"{cont['ttft1']['p50']*1e3:.0f}",
               f"count_{cont['ttft1']['count']}")
    yield ("serve_slo_workload",
           f"{work['n0']}slo_{work['n1']}flood",
           f"contended_dt_{cont['dt']:.1f}s")
    if trace_path:
        yield ("serve_slo_trace_spans", str(len(obs.tracer)), trace_path)


def bench(quick: bool = False, trace_path: Optional[str] = None,
          arch: str = "stablelm-1.6b", preset: str = "smoke", device=None,
          **engine_kw) -> Iterator[Tuple[str, str, str]]:
    """trace_path: write the contended run's Chrome trace JSON here."""
    from .serve_continuous import load_model
    cfg, params, dev = load_model(arch, preset, device)
    work = slo_workload(quick)
    eng, obs = slo_engine(cfg, params, work, device=dev, **engine_kw)
    with eng:
        base = slo_run(eng, obs, work["t0"])         # uncontended
        cont = slo_run(eng, obs, work["merged"])     # saturation
        if trace_path:
            obs.export(trace_path)
    yield from slo_rows(base, cont, work, trace_path, obs)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the contended run's Chrome trace-event "
                         "JSON here")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--device", default=None)
    ap.add_argument("--async-decode", action="store_true")
    args = ap.parse_args()
    for name, val, derived in bench(quick=args.quick, trace_path=args.trace,
                                    preset=args.preset, device=args.device,
                                    async_decode=args.async_decode):
        print(f"{name},{val},{derived}")
