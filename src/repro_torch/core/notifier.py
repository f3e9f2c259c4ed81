"""Two-phase-commit event notifier (EventCount).

Faithful to the paper §4.3: "Event notifier is a two-phase commit protocol
(2PC) that allows a worker to wait on a binary predicate in a non-blocking
fashion" (the Dekker-style EventCount packaged in Eigen, [5] in the paper).

Protocol::

    waiter:   prepare_wait(w)      # phase 1: announce intent, snapshot epoch
              <re-check predicate> # the caller MUST re-inspect its predicate
              commit_wait(w)       # phase 2: sleep unless an epoch bump
              | cancel_wait(w)     #          intervened since phase 1
    notifier: <make predicate true>
              notify_one()/notify_all()

Any ``notify_*`` that happens after ``prepare_wait`` is guaranteed to be
observed by ``commit_wait`` (the epoch snapshot differs), so no wakeup is
lost — exactly the guarantee the paper's Algorithm 6 relies on.

CPython adaptation: the lock-free epoch word becomes an integer guarded by the
condition variable's lock. ``commit_wait`` additionally takes a *liveness
backstop* timeout (default 1s): a production-grade insurance against priority
inversion / missed wakeups that re-checks the epoch and returns control to the
scheduler loop. Spurious returns are counted (``spurious_wakeups``) and safe:
the worker simply re-runs the steal protocol.
"""
from __future__ import annotations

import threading

__all__ = ["Waiter", "EventNotifier"]


class Waiter:
    """Per-worker waiter slot (epoch snapshot)."""

    __slots__ = ("epoch",)

    def __init__(self) -> None:
        self.epoch = -1


class EventNotifier:
    def __init__(self, backstop_s: float = 1.0) -> None:
        self._cond = threading.Condition()
        self._epoch = 0
        self._backstop = backstop_s
        self.num_notifies = 0
        self.num_waits = 0
        self.spurious_wakeups = 0

    # -- waiter side ----------------------------------------------------------
    def prepare_wait(self, w: Waiter) -> None:
        with self._cond:
            w.epoch = self._epoch

    def cancel_wait(self, w: Waiter) -> None:
        w.epoch = -1

    def commit_wait(self, w: Waiter) -> bool:
        """Sleep until an epoch bump (strictly) after ``prepare_wait``.

        Returns True if woken by a notification, False on a backstop timeout.
        """
        with self._cond:
            self.num_waits += 1
            if self._epoch != w.epoch:
                return True  # a notify raced in between phases: consume it
            self._cond.wait(self._backstop)
            if self._epoch == w.epoch:
                # no epoch bump: backstop timeout (or a spurious CV wakeup)
                self.spurious_wakeups += 1
                return False
            # the epoch advanced while waiting — a notification happened,
            # even if the CV wait itself timed out in the same instant
            return True

    # -- notifier side ----------------------------------------------------------
    def notify_one(self) -> None:
        with self._cond:
            self._epoch += 1
            self.num_notifies += 1
            self._cond.notify(1)

    def notify_all(self) -> None:
        with self._cond:
            self._epoch += 1
            self.num_notifies += 1
            self._cond.notify_all()
