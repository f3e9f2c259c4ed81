"""Paper Figure 9: overall system performance on randomly generated DAGs
across graph sizes, comparing the work-stealing executor against the
sequential / levelized (OpenMP-paradigm) / futures baselines. Also reports
peak RSS (the paper's memory panel) and scheduler-efficiency counters.

The port of ``benchmarks/fig9_micro_random_dag.py`` on ``repro_torch.core``:
the same host tasks (a 1K-float numpy vector add each) and row names, plus
``fig9/host_cores`` (``os.cpu_count()``), which bounds every speedup.
"""
from __future__ import annotations

import time

import numpy as np

from .common import (host_cores, peak_rss_mb, random_layered_dag, run_futures,
                     run_levelized, run_sequential, run_taskflow)


def _mk_nodes(n):
    # paper micro-benchmark: each task does a small vector addition (1K)
    xs = np.ones(1024, np.float32)

    def work():
        (xs + xs).sum()

    return [work] * n


def bench(sizes=(1_000, 5_000, 20_000), workers: int = 4):
    rows = []
    for n in sizes:
        _, edges = random_layered_dag(n, width=max(32, n // 50))
        nodes = _mk_nodes(n)
        seq = run_sequential(nodes, edges)
        lvl = run_levelized(nodes, edges, workers)
        fut = run_futures(nodes, edges, workers)
        tfl, prof = run_taskflow(nodes, edges, workers, profile=True)
        rows += [
            (f"fig9/n{n}/sequential_ms", seq * 1e3, "runtime"),
            (f"fig9/n{n}/levelized_ms", lvl * 1e3, "OpenMP-paradigm"),
            (f"fig9/n{n}/futures_ms", fut * 1e3, "thread-pool DAG"),
            (f"fig9/n{n}/taskflow_ms", tfl * 1e3, "work stealing (ours)"),
            (f"fig9/n{n}/taskflow_tasks_per_s", n / tfl, "throughput"),
            (f"fig9/n{n}/steals_ok", prof["steals_ok"], "scheduler counter"),
            (f"fig9/n{n}/sleep_residency", prof["sleep_residency"],
             "adaptive sleeping (energy proxy)"),
        ]
    rows.append(("fig9/peak_rss_mb", peak_rss_mb(), "memory panel"))
    rows.append(("fig9/host_cores", host_cores(), "os.cpu_count()"))
    return rows


if __name__ == "__main__":
    for name, val, derived in bench():
        print(f"{name},{val:.3f},{derived}")
