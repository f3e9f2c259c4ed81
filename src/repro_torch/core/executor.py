"""Heterogeneous work-stealing executor — paper §4, Algorithms 2–8.

Architecture (paper Figure 8):

* one worker pool **per execution domain** (default: ``host`` for CPU work,
  ``accel`` for compiled-XLA work; arbitrary domains supported);
* every worker owns **one task queue per domain** so a task of any domain can
  be produced by any worker without synchronization, but a worker only
  *consumes* (pops/steals) tasks of its own domain;
* one **shared queue + event notifier per domain** for external submission
  and sleep/wake;
* two scheduler-level atomic arrays, ``actives[d]`` and ``thieves[d]``.

Invariant (paper §4.4): *one worker is making steal attempts while an active
worker exists, unless all workers are active* — the last thief to become
active wakes a peer to take over its thief role; cross-domain submissions
wake a worker of the target domain when that domain is fully idle.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .atomic import AtomicInt
from .graph import (ACCEL, HOST, Node, Subflow, Task, Taskflow, TaskType)
from .notifier import EventNotifier, Waiter
from .observer import Observer
from .wsq import WorkStealingQueue

__all__ = ["Executor", "Topology", "TaskError"]

_NSTRIPES = 64


class TaskError(RuntimeError):
    """Raised by Topology.wait() when a task failed; carries the cause."""


class Topology:
    """One execution (or repeated execution) of a taskflow: a future."""

    def __init__(self, taskflow: Taskflow, pred: Optional[Callable[[], bool]],
                 on_complete: Optional[Callable[["Topology"], None]]) -> None:
        self.taskflow = taskflow
        self.pending = AtomicInt(0)
        self.event = threading.Event()
        self.cancelled = False
        self.exceptions: List[BaseException] = []
        self.num_passes = 0
        self._pred = pred
        self._on_complete = on_complete
        self._sources: List[Node] = []

    # -- user API -------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> "Topology":
        if not self.event.wait(timeout):
            raise TimeoutError("topology did not complete in time")
        if self.exceptions:
            raise TaskError(
                f"task failed in taskflow {self.taskflow.name!r}: "
                f"{self.exceptions[0]!r}") from self.exceptions[0]
        return self

    def done(self) -> bool:
        return self.event.is_set()

    def cancel(self) -> None:
        """Stop scheduling successors; already-queued tasks drain as no-ops."""
        self.cancelled = True


class _Worker:
    __slots__ = ("id", "domain", "domain_idx", "queues", "waiter", "rng",
                 "thread", "device")

    def __init__(self, wid: int, domain: str, domain_idx: int, ndomains: int,
                 device: Any = None) -> None:
        self.id = wid
        self.domain = domain
        self.domain_idx = domain_idx
        self.queues = [WorkStealingQueue() for _ in range(ndomains)]
        self.waiter = Waiter()
        self.rng = random.Random(0xC0FFEE ^ wid)
        self.thread: Optional[threading.Thread] = None
        self.device = device


class Executor:
    """Work-stealing executor over heterogeneous domains (paper Algorithm 2-8).

    Parameters
    ----------
    domains:
        mapping domain name -> worker count. Defaults to
        ``{"host": os.cpu_count()}``. Add ``"accel": n`` for device workers.
    devices:
        optional mapping domain name -> list of device objects; worker i of
        that domain is bound to ``devices[d][i % len]`` (paper: "the number
        of domain workers equals the number of domain devices").
    """

    def __init__(self,
                 domains: Optional[Dict[str, int]] = None,
                 devices: Optional[Dict[str, Sequence[Any]]] = None,
                 max_steals: Optional[int] = None,
                 max_yields: int = 100,
                 observer: Optional[Observer] = None) -> None:
        if domains is None:
            domains = {HOST: os.cpu_count() or 1}
        if HOST not in domains:
            domains = {HOST: 1, **domains}
        self._domain_names = list(domains.keys())
        self._dindex = {d: i for i, d in enumerate(self._domain_names)}
        nd = len(self._domain_names)

        self._workers: List[_Worker] = []
        self._workers_by_domain: List[List[_Worker]] = [[] for _ in range(nd)]
        wid = 0
        for d, count in domains.items():
            di = self._dindex[d]
            devs = list((devices or {}).get(d, [])) or [None]
            for k in range(max(1, count)):
                w = _Worker(wid, d, di, nd, devs[k % len(devs)])
                self._workers.append(w)
                self._workers_by_domain[di].append(w)
                wid += 1

        self._shared = [WorkStealingQueue() for _ in range(nd)]
        self._shared_lock = threading.Lock()
        self._notifiers = [EventNotifier() for _ in range(nd)]
        self._actives = [AtomicInt(0) for _ in range(nd)]
        self._thieves = [AtomicInt(0) for _ in range(nd)]
        self._stripes = [threading.Lock() for _ in range(_NSTRIPES)]
        self._stop = False
        self.observer = observer

        self._max_steals = max_steals or (2 * len(self._workers) + 1)
        self._max_yields = max_yields

        self._topo_lock = threading.Lock()
        self._topo_cv = threading.Condition(self._topo_lock)
        self._live_topologies = 0

        for w in self._workers:
            t = threading.Thread(target=self._worker_loop, args=(w,),
                                 name=f"repro-worker-{w.domain}-{w.id}",
                                 daemon=True)
            w.thread = t
            t.start()

    # ------------------------------------------------------------------ public
    @property
    def num_workers(self) -> int:
        return len(self._workers)

    def domain_workers(self, domain: str) -> int:
        return len(self._workers_by_domain[self._dindex[domain]])

    @property
    def domain_names(self) -> List[str]:
        return list(self._domain_names)

    def has_domain(self, domain: str) -> bool:
        return domain in self._dindex

    def run(self, tf: Taskflow,
            on_complete: Optional[Callable[[Topology], None]] = None
            ) -> Topology:
        """Run the taskflow once (paper Listing 1)."""
        return self.run_until(tf, lambda: True, on_complete)

    def run_n(self, tf: Taskflow, n: int,
              on_complete: Optional[Callable[[Topology], None]] = None
              ) -> Topology:
        """Run the taskflow ``n`` times (sequentially)."""
        remaining = [n]

        def pred() -> bool:
            remaining[0] -= 1
            return remaining[0] <= 0

        return self.run_until(tf, pred, on_complete)

    def run_until(self, tf: Taskflow, pred: Callable[[], bool],
                  on_complete: Optional[Callable[[Topology], None]] = None
                  ) -> Topology:
        """Repeatedly run ``tf`` until ``pred()`` is true after a pass."""
        if self._stop:
            raise RuntimeError("executor is shut down")
        topo = Topology(tf, pred, on_complete)
        with self._topo_lock:
            # Per-node run state (_join/_topology) is a soft mapping to ONE
            # live topology (paper §3.3): resubmitting the taskflow while a
            # previous run is in flight would silently corrupt join counters.
            prev = getattr(tf, "_inflight_topology", None)
            if prev is not None and not prev.done():
                raise RuntimeError(
                    f"taskflow {tf.name!r} is already running in a live "
                    "topology; wait() for it to finish (or copy the graph) "
                    "before resubmitting — concurrent runs of one Taskflow "
                    "corrupt per-node join counters (paper §3.3)")
            tf._inflight_topology = topo
            self._live_topologies += 1
        for node in tf._nodes:
            node._topology = topo
            node._parent = None
            node._nested = None
        topo._sources = [n for n in tf._nodes if n.is_source()]
        if not topo._sources:
            if tf._nodes:
                topo.exceptions.append(
                    RuntimeError("taskflow has no source task (paper Fig. 6 "
                                 "pitfall 1: nothing for the scheduler to "
                                 "start with)"))
            self._finalize(None, topo, force=True)
            return topo
        self._submit_sources(None, topo)
        return topo

    def wait_for_all(self) -> None:
        with self._topo_cv:
            while self._live_topologies > 0:
                self._topo_cv.wait(0.05)

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            self.wait_for_all()
        self._stop = True
        for n in self._notifiers:
            n.notify_all()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout=10.0)

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=not any(exc))

    # ---------------------------------------------------------------- internals
    def _stripe(self, node: Node) -> threading.Lock:
        return self._stripes[id(node) % _NSTRIPES]

    def _arm(self, node: Node) -> None:
        with self._stripe(node):
            node._join = node.num_strong

    def _dec_join(self, node: Node) -> int:
        with self._stripe(node):
            node._join -= 1
            return node._join

    # -- Algorithm 8: submit_graph ---------------------------------------------
    def _submit_sources(self, w: Optional[_Worker], topo: Topology) -> None:
        sources = topo._sources
        # arm join counters for the whole pass (pending==0 here: quiescent)
        for node in topo.taskflow._nodes:
            node._join = node.num_strong
        topo.pending.inc(len(sources))  # bulk: no premature completion
        topo.num_passes += 1
        if w is not None:
            # re-submission from a worker (run_until pass): local queues
            for node in sources:
                d = self._dindex[node.domain]
                w.queues[d].push(node)
                if w.domain_idx != d and \
                        self._actives[d].value() == 0 and \
                        self._thieves[d].value() == 0:
                    self._notifiers[d].notify_one()
            return
        # external submission: ONE shared-lock acquisition for the whole
        # source set (was lock-per-node), then one wake per domain that
        # actually received work — the woken thief turning active wakes a
        # replacement (§4.4), so a single notify drains any batch size
        pushed: Dict[int, int] = {}
        with self._shared_lock:
            for node in sources:
                d = self._dindex[node.domain]
                self._shared[d].push(node)
                pushed[d] = pushed.get(d, 0) + 1
        for d in pushed:
            self._notifiers[d].notify_one()

    # -- Algorithm 5: submit_task ------------------------------------------------
    def _schedule(self, w: Optional[_Worker], node: Node,
                  counted: bool = False) -> None:
        topo = node._topology
        if not counted:
            topo.pending.inc()
        parent = node._parent
        if parent is not None and parent._nested is not None:
            parent._nested.inc()
        self._arm(node)  # re-arm join counter (cycle re-entry, paper §3.4)
        d = self._dindex[node.domain]
        if w is not None:
            w.queues[d].push(node)
            if w.domain_idx != d:
                if self._actives[d].value() == 0 and \
                        self._thieves[d].value() == 0:
                    self._notifiers[d].notify_one()
        else:
            with self._shared_lock:
                self._shared[d].push(node)
            self._notifiers[d].notify_one()

    # -- Algorithm 4: execute_task (visitor) ----------------------------------
    def _invoke(self, w: _Worker, node: Node) -> None:
        topo: Topology = node._topology
        obs = self.observer
        if topo.cancelled:
            self._tally_done(w, node)
            return
        if obs:
            obs.on_entry(w.id, w.domain, node)
        result = None
        deferred = False
        try:
            kind = node.kind
            if kind is TaskType.STATIC:
                node.fn()
            elif kind in (TaskType.CONDITION, TaskType.MULTI_CONDITION):
                result = node.fn()
            elif kind is TaskType.DYNAMIC:
                sf = Subflow(node)
                node.fn(sf)
                deferred = self._spawn_children(w, node, sf._nodes,
                                                detached=sf.detached)
            elif kind is TaskType.MODULE:
                child = node.module_target
                deferred = self._spawn_children(w, node, child._nodes,
                                                detached=False)
            elif kind is TaskType.DEVICE:
                # the port has no DeviceFlow yet (queued in ROADMAP.md)
                raise NotImplementedError(
                    "DEVICE tasks need DeviceFlow, not yet in repro_torch")
            else:  # pragma: no cover
                raise RuntimeError(f"unknown task type {kind}")
        except BaseException as e:  # noqa: BLE001 - task isolation
            topo.exceptions.append(e)
            topo.cancelled = True
            deferred = False
        if obs:
            obs.on_exit(w.id, w.domain, node)
        if deferred:
            return  # successors released by the last joining child
        self._release(w, node, result)
        self._tally_done(w, node)

    def _spawn_children(self, w: _Worker, parent: Node,
                        children: List[Node], detached: bool) -> bool:
        """Schedule a subflow / module child graph. Returns True if the
        parent's completion is deferred until the children join."""
        if not children:
            return False
        topo = parent._topology
        sources = [c for c in children if c.is_source()]
        if not sources:
            raise RuntimeError("child graph has no source task")
        for c in children:
            c._topology = topo
            c._parent = None if detached else parent
            c._nested = None
            c._join = c.num_strong
        if detached:
            # paper §3.2: a detached subflow joins at the END of the taskflow
            # — accounted by the topology pending counter only.
            topo.pending.inc(len(sources))
            for c in sources:
                self._schedule(w, c, counted=True)
            return False
        parent._nested = AtomicInt(1)  # self token (latch pattern)
        for c in sources:
            self._schedule(w, c)
        if parent._nested.dec() == 0:  # children already finished (rare race)
            self._finish_join(w, parent)
            return True  # _finish_join released + tallied
        return True

    def _finish_join(self, w: _Worker, parent: Node) -> None:
        """Phase 2 of a joined subflow/module: release the parent's
        successors now that every child (transitively) completed."""
        parent._nested = None
        self._release(w, parent, None)
        self._tally_done(w, parent)

    def _release(self, w: _Worker, node: Node, result: Any) -> None:
        """Release successors (paper Algorithm 4 lines 2-10)."""
        topo: Topology = node._topology
        if topo.cancelled:
            return
        kind = node.kind
        if kind is TaskType.CONDITION:
            if isinstance(result, bool):
                result = int(result)  # pythonic: True->1, False->0
            if not isinstance(result, int):
                return  # non-index return: no successor taken
            if 0 <= result < len(node.successors):
                self._schedule(w, node.successors[result])
        elif kind is TaskType.MULTI_CONDITION:
            if not isinstance(result, (list, tuple)):
                return
            for r in result:
                if isinstance(r, int) and 0 <= r < len(node.successors):
                    self._schedule(w, node.successors[r])
        else:
            for s in node.successors:
                if self._dec_join(s) == 0:
                    self._schedule(w, s)

    def _tally_done(self, w: Optional[_Worker], node: Node) -> None:
        """Account one fully-completed task; propagate joins; detect topology
        completion (paper: executed count balances submitted count)."""
        parent = node._parent
        if parent is not None and parent._nested is not None:
            if parent._nested.dec() == 0:
                self._finish_join(w, parent)
        topo: Topology = node._topology
        if topo.pending.dec() == 0:
            self._finalize(w, topo)

    def _finalize(self, w: Optional[_Worker], topo: Topology,
                  force: bool = False) -> None:
        done = force or topo.cancelled
        if not done:
            try:
                done = bool(topo._pred()) if topo._pred is not None else True
            except BaseException as e:  # noqa: BLE001
                topo.exceptions.append(e)
                done = True
        if not done:
            self._submit_sources(w, topo)  # next pass (run_until / run_n)
            return
        topo.event.set()
        if topo._on_complete is not None:
            try:
                topo._on_complete(topo)
            except BaseException as e:  # noqa: BLE001
                topo.exceptions.append(e)
        with self._topo_cv:
            self._live_topologies -= 1
            self._topo_cv.notify_all()

    # -- Algorithm 2: worker_loop ----------------------------------------------
    def _worker_loop(self, w: _Worker) -> None:
        t: Optional[Node] = None
        while True:
            self._exploit_task(w, t)
            t, alive = self._wait_for_task(w)
            if not alive:
                return

    # -- Algorithm 3: exploit_task -----------------------------------------------
    def _exploit_task(self, w: _Worker, t: Optional[Node]) -> None:
        if t is None:
            return
        d = w.domain_idx
        # adaptive strategy: last thief turning active wakes a replacement
        if self._actives[d].inc() == 1 and self._thieves[d].value() == 0:
            self._notifiers[d].notify_one()
        while t is not None:
            self._invoke(w, t)
            t = w.queues[d].pop()
        self._actives[d].dec()

    # -- Algorithm 7: explore_task -----------------------------------------------
    def _explore_task(self, w: _Worker) -> Optional[Node]:
        d = w.domain_idx
        obs = self.observer
        steals = 0
        yields = 0
        workers = self._workers
        while not self._stop:
            v = workers[w.rng.randrange(len(workers))]
            if v is w:
                t = self._shared[d].steal()
            else:
                t = v.queues[d].steal()
            if t is not None:
                if obs:
                    obs.on_steal(w.id, w.domain, True)
                return t
            if obs:
                obs.on_steal(w.id, w.domain, False)
            steals += 1
            if steals >= self._max_steals:
                time.sleep(0)  # yield
                yields += 1
                if yields >= self._max_yields:
                    return None
        return None

    # -- Algorithm 6: wait_for_task (two-phase commit) -----------------------------
    def _wait_for_task(self, w: _Worker):
        d = w.domain_idx
        notifier = self._notifiers[d]
        obs = self.observer
        self._thieves[d].inc()
        while True:
            t = self._explore_task(w)
            if t is not None:
                if self._thieves[d].dec() == 0:
                    notifier.notify_one()  # last thief: hand over the role
                return t, True
            if self._stop:
                self._thieves[d].dec()
                notifier.notify_all()
                return None, False
            notifier.prepare_wait(w.waiter)
            # re-inspect the shared queue after phase 1 (Algorithm 6 L10-21)
            if not self._shared[d].empty():
                notifier.cancel_wait(w.waiter)
                t = self._shared[d].steal()
                if t is not None:
                    if self._thieves[d].dec() == 0:
                        notifier.notify_one()
                    return t, True
                continue  # goto Line 2: explore again, thief role retained
            if self._stop:
                notifier.cancel_wait(w.waiter)
                self._thieves[d].dec()
                notifier.notify_all()
                return None, False
            if self._thieves[d].dec() == 0:
                # last thief: guard against undetected parallelism
                retry = self._actives[d].value() > 0
                if not retry:
                    for x in self._workers:
                        if not x.queues[d].empty():
                            retry = True
                            break
                if retry:
                    notifier.cancel_wait(w.waiter)
                    self._thieves[d].inc()
                    continue  # goto Line 1
            if obs:
                obs.on_sleep(w.id, w.domain)
            notifier.commit_wait(w.waiter)
            if obs:
                obs.on_wake(w.id, w.domain)
            return None, True  # loop in worker_loop re-enters the protocol
