"""Paper Figure 21 / §5.5: incremental timing-propagation workload
(OpenTimer v1 vs v2 paradigm).

A levelized circuit-like DAG is updated incrementally: each iteration
marks a random frontier of gates dirty and re-propagates arrival times to
the affected cone. v1 (OpenMP paradigm) re-runs the FULL levelized graph
with barriers; v2 (taskflow paradigm) builds the affected-cone TDG and runs
it with work stealing — the paper's speedup comes from propagating only
through the cone and not paying level barriers.

The port of ``benchmarks/fig21_incremental_timing.py`` on
``repro_torch.core`` (host only; the same row names).
"""
from __future__ import annotations

import random
import time
from collections import defaultdict, deque

from repro_torch.core import Executor, Taskflow
from .common import levels_of


def _circuit(n_gates: int, seed: int = 1):
    rng = random.Random(seed)
    edges = []
    for v in range(2, n_gates):
        for u in rng.sample(range(max(0, v - 50), v), min(2, v)):
            edges.append((u, v))
    return edges


def _cone(n, succ, dirty):
    seen = set(dirty)
    q = deque(dirty)
    while q:
        u = q.popleft()
        for v in succ[u]:
            if v not in seen:
                seen.add(v)
                q.append(v)
    return seen


def bench(n_gates: int = 3_000, iters: int = 10, dirty_frac: float = 0.02):
    edges = _circuit(n_gates)
    succ = defaultdict(list)
    pred = defaultdict(list)
    for u, v in edges:
        succ[u].append(v)
        pred[v].append(u)
    at = [0.0] * n_gates          # arrival times
    delay = [random.Random(i).random() for i in range(n_gates)]

    def propagate(v):
        at[v] = delay[v] + max((at[u] for u in pred[v]), default=0.0)

    rng = random.Random(42)
    dirty_sets = [rng.sample(range(n_gates), int(n_gates * dirty_frac))
                  for _ in range(iters)]

    # v1: full levelized re-propagation with barriers every level
    levels = levels_of(n_gates, edges)
    t0 = time.perf_counter()
    for _ in range(iters):
        for level in levels:
            for v in level:
                propagate(v)
    t_v1 = time.perf_counter() - t0

    # v2: affected-cone taskflow per iteration (work stealing, no barriers)
    ex = Executor(domains={"host": 4})
    t0 = time.perf_counter()
    cone_sizes = []
    for dirty in dirty_sets:
        cone = _cone(n_gates, succ, dirty)
        cone_sizes.append(len(cone))
        tf = Taskflow("iter")
        tmap = {}
        for v in sorted(cone):
            tmap[v] = tf.static(lambda v=v: propagate(v))
        for v in cone:
            for u in pred[v]:
                if u in cone:
                    tmap[u].precede(tmap[v])
        ex.run(tf).wait()
    t_v2 = time.perf_counter() - t0
    ex.shutdown(wait=False)

    avg_cone = sum(cone_sizes) / len(cone_sizes)
    return [
        ("fig21/v1_levelized_full_ms", t_v1 * 1e3, "OpenMP paradigm"),
        ("fig21/v2_taskflow_incremental_ms", t_v2 * 1e3,
         "affected-cone TDG"),
        ("fig21/speedup", t_v1 / t_v2, "v2 over v1"),
        ("fig21/avg_cone_gates", avg_cone,
         f"of {n_gates} total"),
    ]


if __name__ == "__main__":
    for name, val, derived in bench():
        print(f"{name},{val:.3f},{derived}")
