"""Executor observer interface + a profiler.

The profiler exposes the counters the paper's evaluation reads off the
runtime: per-worker executed-task counts, steal successes/failures,
sleep/active residency (the paper's energy-efficiency mechanism: fewer
busy-wait cycles), and per-domain utilization — used by the co-run
throughput benchmark (paper Figure 11) and reported in EXPERIMENTS.md.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, Set

__all__ = ["Observer", "Profiler"]


class Observer:
    """Override any subset of hooks; all are called from worker threads."""

    def on_entry(self, worker_id: int, domain: str, task: Any) -> None: ...
    def on_exit(self, worker_id: int, domain: str, task: Any) -> None: ...
    def on_steal(self, worker_id: int, domain: str, ok: bool) -> None: ...
    def on_sleep(self, worker_id: int, domain: str) -> None: ...
    def on_wake(self, worker_id: int, domain: str) -> None: ...


class Profiler(Observer):
    """Aggregating profiler: per-worker AND per-domain counters.

    Every hook registers its worker in the domain's worker set, so
    ``summary()`` normalizes utilization by the number of workers that
    REPORTED (including ones that only ever slept) — a worker that never
    executed a task still holds a core, and counting only the workers in
    ``tasks_executed`` used to overstate utilization on idle domains.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tasks_executed: Dict[int, int] = defaultdict(int)
        self.task_time: Dict[int, float] = defaultdict(float)
        self.steal_ok: Dict[int, int] = defaultdict(int)
        self.steal_fail: Dict[int, int] = defaultdict(int)
        self.sleeps: Dict[int, int] = defaultdict(int)
        self.sleep_time: Dict[int, float] = defaultdict(float)
        #: every worker that fired ANY hook, per domain (and overall)
        self.domain_workers: Dict[str, Set[int]] = defaultdict(set)
        self.domain_tasks: Dict[str, int] = defaultdict(int)
        self.domain_task_time: Dict[str, float] = defaultdict(float)
        self.domain_steal_ok: Dict[str, int] = defaultdict(int)
        self.domain_steal_fail: Dict[str, int] = defaultdict(int)
        self.domain_sleeps: Dict[str, int] = defaultdict(int)
        self.domain_sleep_time: Dict[str, float] = defaultdict(float)
        self._entry_t: Dict[int, float] = {}
        self._sleep_t: Dict[int, float] = {}
        self._t0 = time.perf_counter()

    def on_entry(self, worker_id, domain, task):
        self.domain_workers[domain].add(worker_id)
        self._entry_t[worker_id] = time.perf_counter()

    def on_exit(self, worker_id, domain, task):
        dt = time.perf_counter() - self._entry_t.get(worker_id, time.perf_counter())
        with self._lock:
            self.domain_workers[domain].add(worker_id)
            self.tasks_executed[worker_id] += 1
            self.task_time[worker_id] += dt
            self.domain_tasks[domain] += 1
            self.domain_task_time[domain] += dt

    def on_steal(self, worker_id, domain, ok):
        with self._lock:
            self.domain_workers[domain].add(worker_id)
            if ok:
                self.steal_ok[worker_id] += 1
                self.domain_steal_ok[domain] += 1
            else:
                self.steal_fail[worker_id] += 1
                self.domain_steal_fail[domain] += 1

    def on_sleep(self, worker_id, domain):
        self.domain_workers[domain].add(worker_id)
        self._sleep_t[worker_id] = time.perf_counter()

    def on_wake(self, worker_id, domain):
        t = self._sleep_t.pop(worker_id, None)
        if t is not None:
            with self._lock:
                self.sleeps[worker_id] += 1
                dt = time.perf_counter() - t
                self.sleep_time[worker_id] += dt
                self.domain_sleeps[domain] += 1
                self.domain_sleep_time[domain] += dt

    # -- summaries ----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        wall = time.perf_counter() - self._t0
        with self._lock:
            total_tasks = sum(self.tasks_executed.values())
            busy = sum(self.task_time.values())
            asleep = sum(self.sleep_time.values())
            # workers that fired any hook — NOT len(tasks_executed): a
            # worker that only slept still holds a core of the domain
            nworkers = max(sum(len(s) for s in self.domain_workers.values()),
                           1)
            per_domain: Dict[str, Dict[str, Any]] = {}
            for d, workers in self.domain_workers.items():
                nd = max(len(workers), 1)
                d_busy = self.domain_task_time[d]
                d_sleep = self.domain_sleep_time[d]
                per_domain[d] = {
                    "workers": len(workers),
                    "tasks": self.domain_tasks[d],
                    "busy_s": d_busy,
                    "sleep_s": d_sleep,
                    "steals_ok": self.domain_steal_ok[d],
                    "steals_fail": self.domain_steal_fail[d],
                    "utilization":
                        d_busy / (wall * nd) if wall > 0 else 0.0,
                    "sleep_residency":
                        d_sleep / (wall * nd) if wall > 0 else 0.0,
                }
        return {
            "wall_s": wall,
            "tasks": total_tasks,
            "busy_s": busy,
            "sleep_s": asleep,
            "steals_ok": sum(self.steal_ok.values()),
            "steals_fail": sum(self.steal_fail.values()),
            "workers": nworkers,
            "utilization": busy / (wall * nworkers) if wall > 0 else 0.0,
            "sleep_residency": asleep / (wall * nworkers) if wall > 0 else 0.0,
            "per_domain": per_domain,
        }
