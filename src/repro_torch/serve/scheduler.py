"""Request queue + admission control for the continuous-batching engine.

The scheduler is pure host-side bookkeeping (no jax): it owns the waiting
queues and decides, at every chunk boundary, which requests join the
running batch. The engine's SERIAL admit stage calls
:meth:`Scheduler.try_admit` with the currently free resources; retirement
calls :meth:`finish` / :meth:`fail_all_waiting` to fulfil the request
futures.

Admission policy — *tiered FIFO on prompt-only footprint*:

* requests carry a **priority tier** (``ServeRequest(priority=...)``,
  0 = highest/SLO tier, larger = more best-effort). Each tier is one queue
  ordered **earliest-deadline-first**: requests with a ``deadline_s`` sort
  by their absolute deadline ahead of deadline-less ones, which keep plain
  FIFO (request-id) order among themselves — a pure-FIFO workload is
  byte-identical to the pre-EDF scheduler. Admission scans tiers in strict
  priority order, EDF-then-FIFO within a tier;
* a group is admitted when the block pool covers every member's **prompt**
  KV footprint (not ``prompt + max_new``) and free decode slots exist.
  Decode-time KV is allocated lazily, block by block, as sequences grow
  (:meth:`repro.serve.kvcache.BlockPool.grow_table`); pool exhaustion
  mid-decode preempts a cost-model-selected victim back onto this queue
  (:meth:`requeue_front`) instead of deadlocking;
* the strict scan stops at the first request that does not fit —
  head-of-line order is preserved within and across tiers (a lower tier
  never leapfrogs a blocked higher-tier head). **Per-tier admission
  targets** (``tier_targets={tier: share}``) are the anti-starvation
  escape hatch: ``floor(share * cap)`` seats of every admission cycle are
  reserved for a backlogged tier and filled even when a higher-tier head
  is blocked, so best-effort traffic keeps a guaranteed minimum share
  under sustained SLO load (choose ``share >= 1/max_admit`` for at least
  one seat);
* requests with a **deadline** (``deadline_s``) are swept on every
  admission attempt (and by the engine's per-cycle
  :meth:`expire_waiting`): an expired waiting request fails typed
  (:class:`repro.serve.errors.DeadlineExceeded`) and leaves the queue
  without ever seating. Cancelled requests
  (:meth:`ServeRequest.cancel`) are dropped the same way.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

import numpy as np

from .errors import (DeadlineExceeded, RequestCancelled, ServeError,
                     WatchdogTimeout)

__all__ = ["ServeRequest", "Scheduler"]

_REQ_IDS = itertools.count()


class ServeRequest:
    """One generation request: a prompt plus a future for its output.

    ``submit()`` hands these out; :meth:`result` blocks until the engine's
    complete stage retires the sequence (or the request fails, in which
    case the failure re-raises here instead of deadlocking — typed
    :class:`repro.serve.errors.ServeError` subclasses re-raise directly,
    anything else wraps in a ``RuntimeError``).

    SLO fields: ``priority`` is the scheduling tier (0 = highest;
    admission scans tiers in order, preemption victimizes the highest
    tier number first), ``deadline_s`` an optional per-request latency
    bound measured from submit — an expired request fails
    :class:`DeadlineExceeded` whether it is still queued or mid-decode.
    :meth:`cancel` withdraws the request from any state.

    :attr:`state` tracks the request through the engine — ``"created"`` →
    ``"waiting"`` (queued) → ``"prefilling"`` (admitted, prompt KV being
    chunked in) → ``"decoding"`` → ``"done"``/``"failed"``; a mid-decode
    preemption moves it back to ``"waiting"`` and bumps
    :attr:`preempted_count` (under the async-lookahead engine the tokens
    the in-flight chunk computed for the preempted seat are discarded, and
    the re-run emits an identical stream — greedy decode is
    deterministic). Purely informational (the timeout message below
    reports it); transitions are made by the single SERIAL writer stages,
    so torn reads can at worst be one step stale.
    """

    def __init__(self, prompt: Any, max_new: int, *,
                 priority: int = 0,
                 deadline_s: Optional[float] = None) -> None:
        self.id = next(_REQ_IDS)
        self.prompt = np.asarray(prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if priority < 0:
            raise ValueError("priority must be >= 0 (0 = highest tier)")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.deadline_s = float(deadline_s) if deadline_s is not None \
            else None
        #: absolute perf_counter deadline, stamped by the engine at submit
        self.deadline_at: Optional[float] = None
        self.state = "created"
        self.preempted_count = 0       # mid-decode evictions (see above)
        self._cancel_requested = False
        # SSM/hybrid checkpoint-preemption payload (sync engines): the
        # slot's exact recurrent state + progress, captured at preemption
        # and consumed (re-seated, no prefill replay) at re-admission
        self._ssm_ckpt: Optional[tuple] = None
        # Lifecycle timestamps, all on the time.perf_counter clock (the
        # same clock the tracer uses, so spans and these agree):
        self.submitted_at: Optional[float] = None   # set by the engine
        self.admitted_at: Optional[float] = None    # FIRST admission
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # re-set on every (re-)enqueue / admission — a preempted request's
        # current wait, vs the *_at fields which keep first-occurrence
        self.queued_since: Optional[float] = None
        self.last_admitted_at: Optional[float] = None
        self._done = threading.Event()
        self._tokens: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ future API
    def done(self) -> bool:
        return self._done.is_set()

    def set_result(self, tokens: np.ndarray) -> None:
        self._tokens = tokens
        self.state = "done"
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        if not self._done.is_set():
            self._error = err
            self.state = "failed"
            self._done.set()

    def cancel(self) -> bool:
        """Withdraw the request. Returns False if it already completed
        (result or failure), True otherwise. A still-waiting request fails
        :class:`RequestCancelled` immediately; a seated one is reclaimed
        at the engine's next cycle boundary (blocks/slot released through
        the normal eviction path) and then fails the same way."""
        if self._done.is_set():
            return False
        self._cancel_requested = True
        if self.state in ("created", "waiting"):
            # unblock the caller now; the scheduler drops the queue entry
            # lazily on its next sweep
            self.set_error(RequestCancelled(
                f"request {self.id} cancelled while {self.state}"))
        return True

    def result(self, timeout: Optional[float] = 120.0) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} did not complete within {timeout}s "
                f"(state: {self.state}, preempted {self.preempted_count}x; "
                f"submitted_at={self._fmt(self.submitted_at)} "
                f"admitted_at={self._fmt(self.admitted_at)} "
                f"first_token_at={self._fmt(self.first_token_at)} "
                f"finished_at={self._fmt(self.finished_at)})")
        if self._error is not None:
            if isinstance(self._error, ServeError):
                raise self._error        # typed: callers branch on policy
            raise RuntimeError(
                f"request {self.id} failed in the serve pipeline"
            ) from self._error
        return self._tokens

    @staticmethod
    def _fmt(t: Optional[float]) -> str:
        return f"{t:.3f}" if t is not None else "unset"

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def expired(self, now: Optional[float] = None) -> bool:
        """True once the absolute deadline (if any) has passed."""
        if self.deadline_at is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            > self.deadline_at

    # -------------------------------------------------- derived lifecycle SLOs
    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (submit -> first decode token), or None
        until one exists."""
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def queue_wait(self) -> Optional[float]:
        """Submit -> first admission wait, or None while still queued."""
        if self.admitted_at is None or self.submitted_at is None:
            return None
        return self.admitted_at - self.submitted_at


class Scheduler:
    """Tiered waiting queue + admission-control policy (host side,
    thread-safe). ``tier_targets`` maps a priority tier to its guaranteed
    minimum share of each admission cycle (see module docstring);
    ``on_event(kind, req)`` — kind in ``("expired", "cancelled")`` — is
    called (outside the scheduler lock) whenever a sweep drops a waiting
    request, so the engine can keep its stats/counters current."""

    def __init__(self, max_admit: int = 8,
                 tier_targets: Optional[Dict[int, float]] = None) -> None:
        if max_admit < 1:
            raise ValueError("max_admit must be >= 1")
        self.max_admit = max_admit
        self.tier_targets = {int(t): float(s)
                             for t, s in (tier_targets or {}).items()}
        for t, s in self.tier_targets.items():
            if not 0.0 < s <= 1.0:
                raise ValueError(
                    f"tier_targets[{t}] = {s}: share must be in (0, 1]")
        self.on_event: Optional[Callable[[str, ServeRequest], None]] = None
        self._lock = threading.Lock()
        # one queue per tier, each kept sorted by the EDF key (deadline-or-
        # infinity, then request id): deadline requests admit earliest-
        # deadline-first, deadline-less ones keep FIFO order after them.
        # Enqueue of a deadline-less request is still an O(1) append —
        # its key (inf, monotone id) always sorts last.
        self._queues: Dict[int, Deque[ServeRequest]] = {}
        self._g_depth = None           # serve.queue_depth gauge when bound

    @staticmethod
    def _edf_key(r: ServeRequest) -> tuple:
        """Within-tier admission order: earliest absolute deadline first,
        deadline-less requests after every deadline one in FIFO (id)
        order. Ids are monotone, so the id tiebreak preserves submission
        order among equal deadlines too."""
        d = r.deadline_at
        return (d if d is not None else float("inf"), r.id)

    def set_metrics(self, metrics) -> None:
        """Bind (or unbind with None) a :class:`repro.obs.MetricsRegistry`:
        the scheduler keeps a ``serve.queue_depth`` gauge current at every
        queue mutation. Cheap enough to leave on: queue ops are per-request,
        not per-token."""
        self._g_depth = metrics.gauge("serve.queue_depth") \
            if metrics is not None else None

    def _note_depth_locked(self) -> None:
        if self._g_depth is not None:
            self._g_depth.set(sum(len(q) for q in self._queues.values()))

    def _q_locked(self, tier: int) -> Deque[ServeRequest]:
        q = self._queues.get(tier)
        if q is None:
            q = self._queues[tier] = deque()
        return q

    def _tiers_locked(self) -> List[int]:
        return sorted(t for t, q in self._queues.items() if q)

    # -------------------------------------------------------------- enqueue
    def enqueue(self, req: ServeRequest) -> None:
        req.state = "waiting"
        req.queued_since = time.perf_counter()
        key = self._edf_key(req)
        with self._lock:
            q = self._q_locked(req.priority)
            if not q or key >= self._edf_key(q[-1]):
                q.append(req)    # deadline-less fast path: always lands here
            else:
                self._queues[req.priority] = deque(
                    sorted(list(q) + [req], key=self._edf_key))
            self._note_depth_locked()

    def requeue_front(self, reqs: Iterable[ServeRequest]) -> None:
        """Put preempted (or admission-race-unwound) requests back into
        their tier's line at their EDF-key positions. A plain extendleft
        would suffice from ONE caller, but the decode stage (preemption)
        and the admit stage (alloc-race unwind) can both re-queue
        concurrently — merging by key keeps each tier's EDF/no-starvation
        invariant under that race (for deadline-less requests the key is
        their id, so this is the old FIFO merge)."""
        reqs = sorted(reqs, key=self._edf_key)
        now = time.perf_counter()
        for r in reqs:
            r.state = "waiting"
            r.queued_since = now
        with self._lock:
            for r in reqs:
                q = self._q_locked(r.priority)
                merged = sorted(list(q) + [r], key=self._edf_key)
                self._queues[r.priority] = deque(merged)
            self._note_depth_locked()

    @property
    def num_waiting(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def num_waiting_upto(self, priority: int) -> int:
        """Waiting requests at tiers <= ``priority`` — everything that
        would be admitted ahead of (or alongside) a new request at that
        tier; the load-shed estimator's backlog term."""
        with self._lock:
            return sum(len(q) for t, q in self._queues.items()
                       if t <= priority)

    def waiting_tokens_upto(self, priority: int) -> int:
        """Total decode work (``max_new`` tokens) waiting at tiers <=
        ``priority`` — the backlog term of the service-rate load-shed
        estimator (everything that drains ahead of, or alongside, a new
        request at that tier)."""
        with self._lock:
            return sum(r.max_new for t, q in self._queues.items()
                       if t <= priority for r in q)

    def peek_head(self) -> Optional[ServeRequest]:
        """The request the strict-priority scan would admit next (no pop,
        no sweep): the oldest waiting request of the best backlogged tier.
        The engine's admission-boost pass compares seated rows against
        this head."""
        with self._lock:
            for t in self._tiers_locked():
                for r in self._queues[t]:
                    if not r.done() and not r._cancel_requested:
                        return r
            return None

    def oldest(self) -> Optional[ServeRequest]:
        return self.peek_head()

    # ----------------------------------------------------------------- sweep
    def _sweep_locked(self, now: float) -> List[tuple]:
        """Drop cancelled requests and fail+drop expired ones from every
        tier queue. Returns ``(kind, req)`` events for the caller to emit
        OUTSIDE the lock."""
        events: List[tuple] = []
        for t, q in self._queues.items():
            if not q:
                continue
            kept: Deque[ServeRequest] = deque()
            for r in q:
                if r._cancel_requested or r.done():
                    # cancel() already failed the future (or a racing
                    # cancel landed between state flips) — just drop
                    r.set_error(RequestCancelled(
                        f"request {r.id} cancelled while waiting"))
                    events.append(("cancelled", r))
                elif r.expired(now):
                    r.set_error(DeadlineExceeded(
                        f"request {r.id} deadline "
                        f"({r.deadline_s:.3f}s) expired after "
                        f"{now - (r.submitted_at or now):.3f}s in queue"))
                    events.append(("expired", r))
                else:
                    kept.append(r)
            self._queues[t] = kept
        if events:
            self._note_depth_locked()
        return events

    def _emit(self, events: List[tuple]) -> None:
        cb = self.on_event
        if cb is None:
            return
        for kind, req in events:
            cb(kind, req)

    def expire_waiting(self, now: Optional[float] = None) -> int:
        """Sweep the queues for expired/cancelled waiting requests (the
        engine calls this every decode cycle so deadlines fire promptly
        even while admission is parked). Returns the number dropped."""
        with self._lock:
            events = self._sweep_locked(
                now if now is not None else time.perf_counter())
        self._emit(events)
        return len(events)

    def export_waiting(self) -> List[ServeRequest]:
        """Snapshot copy of every waiting request in admission-scan order
        (tier, then EDF position) — the engine's snapshot writer persists
        these so a drained engine's queue survives a restart even without
        a journal. Pure read; the queues are untouched."""
        with self._lock:
            return [r for t in self._tiers_locked()
                    for r in self._queues[t]
                    if not r.done() and not r._cancel_requested]

    # ------------------------------------------------------------- admission
    def try_admit(self, free_slots: int,
                  blocks_free: Optional[int],
                  need_for: Optional[Callable[[ServeRequest], int]] = None,
                  hopeless: Optional[Callable[[ServeRequest],
                                              Optional[str]]] = None
                  ) -> Optional[List[ServeRequest]]:
        """Pop the next admission group, or None (taking nothing) when no
        waiting request can be covered — the engine turns that into either
        a deferred-token park or a plain decode-pump cycle.

        The block budget charges each member ``need_for(req)`` blocks — the
        request's PROMPT footprint only, minus any prompt blocks the
        engine's prefix cache already holds (a cache-hit admission budgets
        just its uncached suffix, which is exactly why shared-prefix
        traffic admits earlier under load). Decode-time blocks are granted
        lazily by the engine as rows grow. ``blocks_free=None`` skips block
        budgeting entirely (the SSM/hybrid slot-pool path, whose recurrent
        state is pre-allocated per slot). The engine allocates the group's
        blocks AFTER this pop (one all-or-nothing ``BlockPool.alloc``); if
        that races with a concurrent grow it re-queues via
        :meth:`requeue_front`.

        Selection: a strict-priority pass (tiers in order, EDF-then-FIFO
        within — see :meth:`_edf_key`,
        the whole pass stops at the first member that does not fit), then
        the per-tier reserved seats (``tier_targets``) fill for backlogged
        tiers even when the strict pass was blocked. Expired/cancelled
        entries are swept first.

        ``hopeless(req) -> reason | None`` is the engine's preemption-aware
        deadline check: a head whose remaining deadline budget cannot cover
        its estimated remaining prefill+decode at the current service rate
        fails typed :class:`DeadlineExceeded` HERE — popped and failed, no
        blocks charged, the scan continues past it — instead of seating,
        decoding for a while, and expiring mid-stream anyway (wasted pool
        and a doomed preemption). Only consulted for requests the scan is
        about to admit, so an estimate that later improves (service rate
        recovers) never pre-fails deep queue entries.
        """
        with self._lock:
            events = self._sweep_locked(time.perf_counter())
            group: List[ServeRequest] = []
            taken: Dict[int, int] = {}
            tiers = self._tiers_locked()
            if tiers and free_slots >= 1:
                cap = min(self.max_admit, free_slots)
                reserve = {t: min(len(self._queues[t]),
                                  int(self.tier_targets[t] * cap))
                           for t in tiers if t in self.tier_targets}
                # always leave >=1 strict-priority seat: reserved shares
                # that floor-round up to the whole cap must not lock the
                # top tier out of its own admission cycle
                strict_cap = max(1, cap - sum(reserve.values()))
                budget = blocks_free
                # pass 1 — strict priority, global head-of-line
                blocked = False
                for t in tiers:
                    for r in self._queues[t]:
                        if len(group) >= strict_cap:
                            break
                        why = hopeless(r) if hopeless is not None else None
                        if why is not None:
                            r.set_error(DeadlineExceeded(why))
                            events.append(("expired", r))
                            taken[t] = taken.get(t, 0) + 1
                            continue
                        if budget is not None:
                            need = need_for(r)
                            if need > budget:
                                blocked = True
                                break
                            budget -= need
                        group.append(r)
                        taken[t] = taken.get(t, 0) + 1
                    if blocked or len(group) >= strict_cap:
                        break
                # pass 2 — reserved seats: a backlogged target tier admits
                # its guaranteed share even when a higher-tier head blocked
                # the strict pass
                for t in sorted(reserve):
                    want = reserve[t]
                    q = self._queues[t]
                    while want > 0 and taken.get(t, 0) < len(q) \
                            and len(group) < cap:
                        r = q[taken.get(t, 0)]
                        why = hopeless(r) if hopeless is not None else None
                        if why is not None:
                            r.set_error(DeadlineExceeded(why))
                            events.append(("expired", r))
                            taken[t] = taken.get(t, 0) + 1
                            continue
                        if budget is not None:
                            need = need_for(r)
                            if need > budget:
                                break
                            budget -= need
                        group.append(r)
                        taken[t] = taken.get(t, 0) + 1
                        want -= 1
            for t, k in taken.items():
                q = self._queues[t]
                for _ in range(k):
                    q.popleft()
            if taken:
                self._note_depth_locked()
            if group:
                now = time.perf_counter()
                for req in group:
                    req.last_admitted_at = now
        self._emit(events)
        return group or None

    # ------------------------------------------------------------ retirement
    def finish(self, req: ServeRequest, tokens: np.ndarray, now: float
               ) -> None:
        req.finished_at = now
        req.set_result(tokens)

    def fail_all_waiting(self, err: BaseException) -> None:
        """Resident pipeline died: fail queued requests so result() raises
        instead of timing out."""
        with self._lock:
            waiting = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._note_depth_locked()
        for r in waiting:
            r.set_error(err)
