"""Atomic integer used for the scheduler's actives/thieves/pending counters."""
from __future__ import annotations

import threading

__all__ = ["AtomicInt"]


class AtomicInt:
    """Lock-guarded counter with fetch-style semantics.

    (CPython's ``+=`` on attributes is a read-modify-write and is *not*
    atomic across threads; the paper's counters are std::atomic, so we guard
    with a mutex — contention is negligible at scheduler scale.)
    """

    __slots__ = ("_v", "_lock")

    def __init__(self, v: int = 0) -> None:
        self._v = v
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        """Add ``n`` and return the NEW value (paper's AtomInc)."""
        with self._lock:
            self._v += n
            return self._v

    def dec(self, n: int = 1) -> int:
        """Subtract ``n`` and return the NEW value (paper's AtomDec)."""
        with self._lock:
            self._v -= n
            return self._v

    def value(self) -> int:
        with self._lock:
            return self._v

    def set(self, v: int) -> None:
        with self._lock:
            self._v = v

    def __repr__(self) -> str:  # pragma: no cover
        return f"AtomicInt({self.value()})"
