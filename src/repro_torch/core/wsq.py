"""Work-stealing queue (Chase-Lev access discipline).

The paper implements the lock-free deque of Le et al. [PPoPP'13]: the owner
pushes/pops one end while thieves steal from the other end concurrently.

CPython adaptation (see DESIGN.md §2.3): ``collections.deque`` operations are
atomic under the GIL, which subsumes the C++11 memory-model fences of the
original algorithm. We preserve the *access discipline* — only the owning
worker calls :meth:`push`/:meth:`pop` (bottom), any thread may call
:meth:`steal` (top) — so the scheduling behaviour (LIFO for the owner for
locality, FIFO for thieves for load spreading) matches the paper exactly.
"""
from __future__ import annotations

import collections
from typing import Any, Optional

__all__ = ["WorkStealingQueue"]


class WorkStealingQueue:
    """Single-owner, multi-thief task queue."""

    __slots__ = ("_q",)

    def __init__(self) -> None:
        self._q: collections.deque = collections.deque()

    # -- owner end (bottom) -------------------------------------------------
    def push(self, item: Any) -> None:
        """Owner-only: push a task to the bottom of the queue."""
        self._q.append(item)

    def pop(self) -> Optional[Any]:
        """Owner-only: pop the most recently pushed task (LIFO locality)."""
        try:
            return self._q.pop()
        except IndexError:
            return None

    # -- thief end (top) ----------------------------------------------------
    def steal(self) -> Optional[Any]:
        """Any thread: steal the oldest task (FIFO spreading)."""
        try:
            return self._q.popleft()
        except IndexError:
            return None

    # -- introspection --------------------------------------------------------
    def empty(self) -> bool:
        return not self._q

    def __len__(self) -> int:
        return len(self._q)

    def __repr__(self) -> str:  # pragma: no cover
        return f"WorkStealingQueue(len={len(self._q)})"
