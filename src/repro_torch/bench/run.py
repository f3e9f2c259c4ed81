"""Benchmark harness of the port: one module per paper table or figure.

The port of ``benchmarks/run.py``:

    PYTHONPATH=src python -m repro_torch.bench.run [--only fig9,...]
        [--quick] [--bench-dir DIR] [--device cuda|cpu]
        [--prompt-dist choice|lognormal] [--prefix-share]

table2       — task/edge creation overheads (paper Table 2)
fig9         — random-DAG runtime/memory vs baselines (paper Figure 9)
fig11        — co-run throughput + utilization (paper Figure 11)
fig13        — LSDNN inference (paper Figure 13, §5.3; K4 on the card)
fig17        — conditional-vs-unrolled memory (paper Figure 17): the host
               TDG rows and, on the card, the CondGraph WHILE program
               against the unrolled CUDA graph and the host-driven loop
fig21        — incremental timing propagation (paper Figure 21, §5.5)
pipeline     — task-parallel pipeline throughput vs hand-rolled loops
               (Pipeflow follow-up, arXiv:2202.00717)
paged_decode — K1 vs its plain page loop and the gather oracle across
               pool occupancies at stablelm-1.6b's full-width heads, and
               the full-width decode step
serve        — continuous batching under a Poisson trace, percentiles
               read from the ``repro_torch.obs`` registry (``--prompt-dist``);
               ``--prefix-share`` runs the prefix-cache workload, cold
               against warm; its trace lands in ``TRACE_serve.json``
obs_gate     — serve throughput with observability on against off
decode_overlap — the synchronous against the async decode engine: per-
               cycle dispatch / sync / bookkeeping and the host gap, in
               turns, with an fp32 parity pass
serve_slo    — SLO overload control: tier-0 tail TTFT alone and under a
               tier-1 best-effort flood (shedding, deadline expiry, cost-
               model preemption); its contended run's trace lands in
               ``TRACE_serve_slo.json``

Not ported yet (ROADMAP.md Queue 1): ``journal_gate`` waits for item 7,
``serve_mesh`` for item 11 and ``roofline`` for item 14; the ``serve``
suite's per-call baseline rows are not ported (the port's engine has no
per-call grouped path).

``--quick`` shrinks every suite to seconds: table2 20,000 operations,
fig9 graphs of 1,000 and 5,000 tasks, fig11 1,000 tasks, fig21 1,000
gates over 5 iterations, fig13 8 layers, the pipeline and paged_decode
suites their own quick sizes (paged_decode keeps the full-width heads),
serve, obs_gate, decode_overlap and serve_slo the reference's quick
sizes.
The suites run on the card unless ``--device cpu`` is given (the tests);
without a card the default raises. Each completed suite drops
``BENCH_<suite>.json`` into ``--bench-dir`` with the schema of
``benchmarks/run.py``: the run config, every row, the well-known metrics
(``tok_per_s`` / ``p50_ms`` / ``p99_ms`` rows) and provenance (git sha +
ISO-8601 UTC timestamp), plus the device the suite ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from datetime import datetime, timezone

#: row-name suffix -> trajectory metric key (suite-agnostic extraction)
_METRIC_SUFFIXES = ("tok_per_s", "p50_ms", "p99_ms")

#: suites of ``benchmarks/run.py`` the port does not have yet, with the
#: ROADMAP Queue 1 item each waits for
NOT_PORTED = {"journal_gate": "item 7",
              "serve_mesh": "item 11", "roofline": "item 14"}


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except OSError:
        return ""


def _write_trajectory(bench_dir: str, suite: str, config: dict,
                      rows: list, elapsed_s: float) -> str:
    metrics = {}
    for name, val, _ in rows:
        for suffix in _METRIC_SUFFIXES:
            if name.endswith(suffix):
                try:
                    metrics[name] = float(val)
                except ValueError:
                    pass
    payload = {
        "suite": suite,
        "config": config,
        "git_sha": _git_sha(),
        "timestamp": time.time(),
        "timestamp_iso": datetime.now(timezone.utc).isoformat(),
        "elapsed_s": round(elapsed_s, 3),
        "rows": [{"name": n, "value": v, "derived": d} for n, v, d in rows],
        "metrics": metrics,
    }
    os.makedirs(bench_dir, exist_ok=True)
    path = os.path.join(bench_dir, f"BENCH_{suite}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def _card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type."""
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def suites(dev, quick: bool, prompt_dist: str = "choice",
           prefix_share: bool = False, trace_dir: str = ".") -> dict:
    from . import (decode_overlap, fig9_micro_random_dag,
                   fig11_corun_throughput, fig13_lsdnn,
                   fig17_conditional_memory,
                   fig21_incremental_timing, obs_overhead_gate,
                   paged_decode_microbench, pipeline_throughput,
                   serve_continuous, serve_slo, table2_task_overhead)
    trace = os.path.join(trace_dir, "TRACE_serve.json")
    return {
        "table2": lambda: table2_task_overhead.bench(
            20_000 if quick else 200_000),
        "fig9": lambda: fig9_micro_random_dag.bench(
            sizes=(1_000, 5_000) if quick else (1_000, 5_000, 20_000)),
        "fig11": lambda: fig11_corun_throughput.bench(
            n_tasks=1_000 if quick else 4_000),
        "fig13": lambda: fig13_lsdnn.bench(
            layers=8 if quick else None, device=dev),
        "fig17": lambda: fig17_conditional_memory.bench(device=dev),
        "fig21": lambda: fig21_incremental_timing.bench(
            *((1_000, 5) if quick else ())),
        "pipeline": lambda: pipeline_throughput.bench(quick=quick,
                                                      device=dev),
        "paged_decode": lambda: paged_decode_microbench.bench(
            quick=quick, device=dev),
        "serve": lambda: (
            serve_continuous.bench_prefix_share(
                quick=quick, trace_path=trace, device=dev)
            if prefix_share else
            serve_continuous.bench(quick=quick, prompt_dist=prompt_dist,
                                   trace_path=trace, device=dev)),
        "obs_gate": lambda: obs_overhead_gate.bench(quick=quick,
                                                    device=dev),
        "decode_overlap": lambda: decode_overlap.bench(
            quick=quick, device=dev,
            trace_path=os.path.join(trace_dir, "TRACE_decode_overlap.json")),
        "serve_slo": lambda: serve_slo.bench(
            quick=quick, device=dev,
            trace_path=os.path.join(trace_dir, "TRACE_serve_slo.json")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="not ported yet: " + ", ".join(
            f"{s} (ROADMAP Queue 1 {w})" for s, w in NOT_PORTED.items()))
    ap.add_argument("--only", default="",
                    help="comma-separated suites (default: all ported)")
    ap.add_argument("--quick", action="store_true",
                    help="seconds-scale sizes (see the module docstring)")
    ap.add_argument("--bench-dir", default=".",
                    help="where BENCH_<suite>.json trajectory files land")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the host suites and the plain versions")
    ap.add_argument("--prompt-dist", default="choice",
                    choices=("choice", "lognormal"),
                    help="serve suite prompt-length distribution "
                         "(lognormal = heavy tail)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="serve suite: shared-prefix workload, cold vs "
                         "warm prefix cache over one trace")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    dev = resolve_device(args.device)
    os.makedirs(args.bench_dir, exist_ok=True)
    table = suites(dev, args.quick, args.prompt_dist, args.prefix_share,
                   args.bench_dir)
    only = [s for s in args.only.split(",") if s]
    for name in only:
        if name not in table:
            wait = NOT_PORTED.get(name)
            raise SystemExit(
                f"suite {name!r} is not ported yet (waits for ROADMAP "
                f"Queue 1 {wait})" if wait else
                f"unknown suite {name!r}; ported: {sorted(table)}")
    card = _card(dev)
    print(f"# device: {card}", flush=True)
    config = {"quick": args.quick, "only": args.only,
              "device": str(dev), "card": card,
              "host_cores": os.cpu_count(),
              "prompt_dist": args.prompt_dist,
              "prefix_share": args.prefix_share,
              "paged_impl_env": os.environ.get("REPRO_PAGED_IMPL", ""),
              "obs_gate_budget_env":
                  os.environ.get("REPRO_OBS_GATE_BUDGET", "")}
    failures = 0
    for name, fn in table.items():
        if only and name not in only:
            continue
        t0 = time.time()
        try:
            rows = []
            for row_name, val, derived in fn():
                rows.append((row_name, val, derived))
                print(f"{row_name},{val},{derived}", flush=True)
            elapsed = time.time() - t0
            path = _write_trajectory(args.bench_dir, name, config, rows,
                                     elapsed)
            print(f"# {name} done in {elapsed:.1f}s -> {path}", flush=True)
        except Exception as e:  # noqa: BLE001 — one suite's failure
            failures += 1       # is reported and the others still run
            print(f"# {name} FAILED: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
