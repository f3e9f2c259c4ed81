"""Typed serve-runtime errors (SLO-aware overload control).

Every failure mode the engine can impose on a request has a distinct
exception type, raised DIRECTLY from :meth:`ServeRequest.result` (no
``RuntimeError`` wrapping) so callers can branch on policy:

* :class:`Overloaded`       — rejected at ``submit()`` (load shedding):
  the estimated queue wait exceeds the tier's latency budget, or the
  request's own deadline is already unreachable. Synchronous — the
  request never enters the queue.
* :class:`DeadlineExceeded` — the request's ``deadline_s`` elapsed while
  waiting in the queue or mid-decode; its blocks/slot were reclaimed.
* :class:`RequestCancelled` — :meth:`ServeRequest.cancel` was honored.
* :class:`RowFailed`        — a raising decode/prefill step failed the
  seated rows; the engine itself kept serving (``__cause__`` carries
  the original exception).
* :class:`WatchdogTimeout`  — the engine watchdog detected a stuck cycle
  (no sync progress within ``watchdog_s``) and failed all in-flight
  futures with a diagnostic instead of letting ``result()`` hang.
* :class:`EngineClosed`     — ``close()`` gave up draining (or the
  engine was torn down / draining) with the request still outstanding.
* :class:`SnapshotCorrupt`  — a state snapshot failed integrity checks
  on restore (bad magic/length/checksum/version). Unlike the others
  this is raised to the *operator* path, not a request future: callers
  catch it and cold-start (durability can lose warmth, never serve
  wrong tokens).

All derive from :class:`ServeError` (a ``RuntimeError``); the
deadline/watchdog pair additionally subclass :class:`TimeoutError` so
generic timeout handling catches them.
"""
from __future__ import annotations

__all__ = ["ServeError", "Overloaded", "DeadlineExceeded", "TPUnsupported",
           "RequestCancelled", "RowFailed", "WatchdogTimeout",
           "EngineClosed", "SnapshotCorrupt"]


class ServeError(RuntimeError):
    """Base class for typed serve-runtime request failures."""


class Overloaded(ServeError):
    """Load shed at submit: estimated queue wait exceeds the latency
    budget for this request's tier (or its deadline is unreachable)."""

    def __init__(self, msg: str, *, tier: int = 0,
                 est_wait_s: float = 0.0, budget_s: float = 0.0,
                 queue_depth: int = 0) -> None:
        super().__init__(msg)
        self.tier = tier
        self.est_wait_s = est_wait_s
        self.budget_s = budget_s
        self.queue_depth = queue_depth


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's ``deadline_s`` elapsed before completion."""


class RequestCancelled(ServeError):
    """The request was cancelled via :meth:`ServeRequest.cancel`."""


class RowFailed(ServeError):
    """A raising model step failed this seated row; the engine kept
    serving (``__cause__`` carries the original exception)."""


class WatchdogTimeout(ServeError, TimeoutError):
    """The engine watchdog fired: no cycle progress within the budget."""


class EngineClosed(ServeError):
    """The engine was closed/torn down with this request outstanding."""


class TPUnsupported(ServeError, ValueError):
    """A mode the tensor-parallel engine does not carry across to its
    followers (the captured chunk: ``gloo`` collectives cannot be
    captured): refused at construction."""


class SnapshotCorrupt(ServeError):
    """A state snapshot failed integrity verification on restore; the
    caller must fall back to a cold start."""
