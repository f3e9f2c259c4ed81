"""Composable parallel algorithms built on the taskflow model.

The paper ships ``parallel_for`` / reductions / pipelines as library
algorithms on top of the same graph primitives; the data pipeline and the
benchmarks use these.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

from .graph import HOST, Task, Taskflow

__all__ = ["parallel_for", "parallel_reduce", "linear_pipeline"]


def parallel_for(tf: Taskflow, n: int, body: Callable[[int], None],
                 chunk: int = 1, domain: str = HOST) -> tuple:
    """Add tasks running ``body(i) for i in range(n)`` in ``chunk``-sized
    blocks. Returns (entry, exit) synchronization tasks."""
    entry = tf.static(lambda: None, name="pfor-entry")
    exit_ = tf.static(lambda: None, name="pfor-exit")
    chunk = max(1, chunk)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)

        def run(lo=lo, hi=hi):
            for i in range(lo, hi):
                body(i)

        t = tf.static(run, name=f"pfor-{lo}", domain=domain)
        entry.precede(t)
        t.precede(exit_)
    return entry, exit_


def parallel_reduce(tf: Taskflow, items: Sequence[Any],
                    op: Callable[[Any, Any], Any], init: Any,
                    result: List[Any], chunk: int = 8) -> tuple:
    """Tree-free chunked reduction: chunks reduce locally, exit combines.
    ``result[0]`` holds the value after the exit task runs."""
    lock = threading.Lock()
    partials: List[Any] = []
    entry = tf.static(lambda: None, name="preduce-entry")

    def combine():
        acc = init
        for p in partials:
            acc = op(acc, p)
        result[0] = acc

    exit_ = tf.static(combine, name="preduce-exit")
    items = list(items)
    chunk = max(1, chunk)
    for lo in range(0, len(items), chunk):
        hi = min(len(items), lo + chunk)

        def run(lo=lo, hi=hi):
            acc = None
            first = True
            for x in items[lo:hi]:
                acc = x if first else op(acc, x)
                first = False
            with lock:
                partials.append(acc)

        t = tf.static(run, name=f"preduce-{lo}")
        entry.precede(t)
        t.precede(exit_)
    return entry, exit_


def linear_pipeline(tf: Taskflow, stages: Sequence[Callable[[Any], Any]],
                    source: Callable[[], Optional[Any]],
                    sink: Callable[[Any], None],
                    depth: int = 4) -> Task:
    """Token-based software pipeline (paper's pipeline pattern): up to
    ``depth`` tokens in flight, each flowing through ``stages`` in order.

    Built with a conditional cycle: a scheduler condition task keeps
    re-entering while the source yields tokens — no unrolling.
    """
    state = {"inflight": 0, "done": False}
    lock = threading.Lock()

    def pump(sf):
        # dynamic task: spawn one chain per available token, then re-check
        spawned = 0
        while True:
            with lock:
                if state["done"] or state["inflight"] >= depth:
                    break
            item = source()
            if item is None:
                with lock:
                    state["done"] = True
                break
            with lock:
                state["inflight"] += 1
            # build one stage-chain per token; the box threads the value
            # (bind box per-iteration: closures must NOT share the loop var)
            box = {"v": item}

            def mk(stage, box=box):
                def run():
                    box["v"] = stage(box["v"])
                return run

            chain = [sf.static(mk(s), name=f"stage{si}")
                     for si, s in enumerate(stages)]

            def finish(box=box):
                sink(box["v"])
                with lock:
                    state["inflight"] -= 1

            chain.append(sf.static(finish, name="sink"))
            for a, b in zip(chain, chain[1:]):
                a.precede(b)
            spawned += 1

    pump_t = tf.dynamic(pump, name="pipeline-pump")

    def again() -> int:
        with lock:
            return 1 if state["done"] and state["inflight"] == 0 else 0

    cond = tf.condition(again, name="pipeline-cond")
    stop = tf.static(lambda: None, name="pipeline-stop")
    # zero-dependency source (paper Fig. 6 pitfall 1: a pure cycle has
    # nothing for the scheduler to start with)
    init = tf.static(lambda: None, name="pipeline-init")
    init.precede(pump_t)
    pump_t.precede(cond)
    cond.precede(pump_t, stop)  # 0 -> loop back, 1 -> stop
    return stop
