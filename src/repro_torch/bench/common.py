"""Shared benchmark scaffolding: baseline schedulers the paper compares
against, reimplemented as *paradigms* (the C++ frameworks themselves are not
available in-process). The port of ``benchmarks/common.py`` on the port's
host runtime (``repro_torch.core``):

* ``sequential``   — topological order, one thread (lower bound on overhead)
* ``levelized``    — level-by-level with barriers, the paper's description
                     of the OpenMP baseline ("levelize the graph and
                     propagate computations level by level")
* ``futures``      — concurrent.futures.ThreadPoolExecutor DAG scheduler
                     (an industrial work-queue runtime without work stealing
                     or adaptive sleep)
* ``taskflow``     — our reproduction of the paper's work-stealing executor

All consume the same graph description: ``nodes = [callable, ...]``,
``edges = [(u, v), ...]``.

The wall-clock *speedups* between schedulers depend on the host's cores:
fig9 and fig11 report ``os.cpu_count()`` beside their rows
(:func:`host_cores`). On a one-core host what stays comparable (and what
the paper's Tables 1-2 measure) are per-task overheads, scheduling
efficiency counters (steals, sleeps, utilization), memory, and graph-size
scaling.
"""
from __future__ import annotations

import gc
import os
import resource
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core import Executor, Profiler, Taskflow

Edge = Tuple[int, int]


def host_cores() -> int:
    return os.cpu_count() or 1


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_sequential(nodes: Sequence[Callable], edges: Sequence[Edge]) -> float:
    order = topo_order(len(nodes), edges)
    t0 = time.perf_counter()
    for i in order:
        nodes[i]()
    return time.perf_counter() - t0


def topo_order(n: int, edges: Sequence[Edge]) -> List[int]:
    succ = defaultdict(list)
    indeg = [0] * n
    for u, v in edges:
        succ[u].append(v)
        indeg[v] += 1
    q = deque(i for i in range(n) if indeg[i] == 0)
    order = []
    while q:
        u = q.popleft()
        order.append(u)
        for v in succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                q.append(v)
    return order


def levels_of(n: int, edges: Sequence[Edge]) -> List[List[int]]:
    succ = defaultdict(list)
    indeg = [0] * n
    for u, v in edges:
        succ[u].append(v)
        indeg[v] += 1
    level = [0] * n
    for u in topo_order(n, edges):
        for v in succ[u]:
            level[v] = max(level[v], level[u] + 1)
    out: Dict[int, List[int]] = defaultdict(list)
    for i, l in enumerate(level):
        out[l].append(i)
    return [out[l] for l in sorted(out)]


def run_levelized(nodes: Sequence[Callable], edges: Sequence[Edge],
                  workers: int = 4) -> float:
    """OpenMP-paradigm baseline: barrier after every level."""
    lv = levels_of(len(nodes), edges)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for level in lv:
            list(pool.map(lambda i: nodes[i](), level))
    return time.perf_counter() - t0


def run_futures(nodes: Sequence[Callable], edges: Sequence[Edge],
                workers: int = 4) -> float:
    """Dependency-counting scheduler on a plain thread pool."""
    import threading
    succ = defaultdict(list)
    indeg = defaultdict(int)
    n = len(nodes)
    for u, v in edges:
        succ[u].append(v)
        indeg[v] += 1
    lock = threading.Lock()
    done = threading.Event()
    remaining = [n]
    pool = ThreadPoolExecutor(max_workers=workers)

    def submit(i):
        pool.submit(run, i)

    def run(i):
        nodes[i]()
        ready = []
        with lock:
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
            for v in succ[i]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        for v in ready:
            submit(v)

    t0 = time.perf_counter()
    for i in range(n):
        if indeg[i] == 0:
            submit(i)
    done.wait()
    dt = time.perf_counter() - t0
    pool.shutdown(wait=False)
    return dt


def run_taskflow(nodes: Sequence[Callable], edges: Sequence[Edge],
                 workers: int = 4, profile: bool = False):
    prof = Profiler() if profile else None
    ex = Executor(domains={"host": workers}, observer=prof)
    tf = Taskflow("bench")
    tasks = [tf.static(fn) for fn in nodes]
    for u, v in edges:
        tasks[u].precede(tasks[v])
    t0 = time.perf_counter()
    ex.run(tf).wait()
    dt = time.perf_counter() - t0
    ex.shutdown(wait=False)
    if profile:
        return dt, prof.summary()
    return dt


def random_layered_dag(n_tasks: int, width: int = 64, fan_in: int = 3,
                       seed: int = 0) -> Tuple[int, List[Edge]]:
    import random as _r
    rng = _r.Random(seed)
    edges: List[Edge] = []
    layers: List[List[int]] = []
    i = 0
    while i < n_tasks:
        w = min(width, n_tasks - i)
        layer = list(range(i, i + w))
        if layers:
            prev = layers[-1]
            for v in layer:
                for u in rng.sample(prev, min(fan_in, len(prev))):
                    edges.append((u, v))
        layers.append(layer)
        i += w
    return n_tasks, edges
