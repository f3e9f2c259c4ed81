"""Paper Figure 11: throughput of co-running task graphs (weighted speedup)
plus CPU-utilization proxies from the executor profiler.

Weighted speedup = sum_i (t_solo / t_i_in_corun); 1.0 means the corun is as
good as running the programs consecutively (paper's definition from [23]).

Utilization is taken from the profiler's PER-DOMAIN summary (normalized
by every worker that reported any hook, sleepers included — workers that
never won a task still hold their cores).

The port of ``benchmarks/fig11_corun_throughput.py`` on ``repro_torch.core``:
the same rows, plus ``fig11/host_cores`` (``os.cpu_count()``).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import Executor, Profiler, Taskflow
from .common import host_cores, random_layered_dag


def _build(tfname, n, edges, work):
    tf = Taskflow(tfname)
    tasks = [tf.static(work) for _ in range(n)]
    for u, v in edges:
        tasks[u].precede(tasks[v])
    return tf


def bench(n_tasks: int = 4_000, coruns=(1, 2, 4, 6)):
    xs = np.ones(1024, np.float32)

    def work():
        (xs + xs).sum()

    n, edges = random_layered_dag(n_tasks, width=64)
    rows = []
    # solo time
    prof = Profiler()
    ex = Executor(domains={"host": 4}, observer=prof)
    tf0 = _build("solo", n, edges, work)
    t0 = time.perf_counter()
    ex.run(tf0).wait()
    t_solo = time.perf_counter() - t0
    ex.shutdown(wait=False)
    rows.append(("fig11/solo_ms", t_solo * 1e3, "baseline"))
    rows.append(("fig11/host_cores", host_cores(), "os.cpu_count()"))

    for k in coruns:
        prof = Profiler()
        ex = Executor(domains={"host": 4}, observer=prof)
        tfs = [_build(f"corun{i}", n, edges, work) for i in range(k)]
        t0 = time.perf_counter()
        topos = [ex.run(tf) for tf in tfs]
        for tp in topos:
            tp.wait()
        dt = time.perf_counter() - t0
        s = prof.summary()
        ex.shutdown(wait=False)
        weighted = sum(t_solo / dt for _ in range(k))
        host = s["per_domain"].get("host", s)
        rows += [
            (f"fig11/corun{k}/weighted_speedup", weighted,
             ">=1 is consecutive-equivalent"),
            (f"fig11/corun{k}/utilization", host["utilization"],
             f"host busy fraction over {host.get('workers', 0)} workers"),
            (f"fig11/corun{k}/sleep_residency", host["sleep_residency"],
             "adaptive sleeping"),
            (f"fig11/corun{k}/steals_ok", float(host["steals_ok"]),
             f"{host['steals_fail']}_failed"),
        ]
    return rows


if __name__ == "__main__":
    for name, val, derived in bench():
        print(f"{name},{val:.3f},{derived}")
