"""Low-overhead span recorder for the serve-layer timeline (tfprof-style).

The Taskflow paper ships a built-in profiler (tfprof, §VI) that records
per-worker task intervals and renders them as an execution timeline; this
module is the serve-stack analogue. A :class:`Tracer` holds a bounded RING
BUFFER of completed spans — plain ``(name, track, t_start, t_end, args)``
tuples on the ``time.perf_counter`` clock — that the engine, the pipeline
and the launcher append to from worker threads:

* **tracks** partition the timeline the way tfprof partitions by worker:
  one track per decode slot (``"slot3"``) carrying that seat's request
  lifecycle spans (queued → admitted → prefill_window → decode →
  stalled → retired), one ``"engine"`` track carrying the per-cycle phase
  spans (admission, merge, prefill_window, growth, dispatch, sync,
  bookkeeping, cycle), and one ``"lineN"`` track per pipeline line with
  the raw pipe-body intervals (the promotion of
  :attr:`repro_torch.pipeline.Pipeline.stage_times` into spans);
* an *instant* is a span with ``t_end == t_start`` (exported as a Chrome
  trace instant event) — used for point events like ``retired`` and
  ``preempted``.

Design constraints (the serve hot loop calls this every cycle):

* ``add`` is one lock acquisition + one list write; the buffer never
  grows past ``capacity`` — old spans are overwritten oldest-first and
  counted in :attr:`dropped` (a trace that wrapped says so instead of
  silently lying);
* a disabled tracer (``enabled=False``) returns before touching the lock,
  and every instrumentation site in the engine additionally guards on its
  obs handle being ``None``, so the disabled path costs attribute checks
  only (the <2%% overhead budget on the quick serve bench).

Export to Chrome trace-event JSON (Perfetto / ``chrome://tracing``) lives
in :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "TRACK_ENGINE"]

#: the engine-cycle track name (one per engine; slot tracks are "slotN")
TRACK_ENGINE = "engine"

#: (name, track, t_start, t_end, args) — t_* on the perf_counter clock
Span = Tuple[str, str, float, float, Optional[Dict[str, Any]]]


class Tracer:
    """Thread-safe bounded span recorder (see module docstring).

    Parameters
    ----------
    capacity:
        ring-buffer size in spans; the newest ``capacity`` spans are kept
        and :attr:`dropped` counts overwritten ones.
    enabled:
        ``False`` makes every recording method a near-no-op (checked
        before the lock). Flip :attr:`enabled` at will — recording sites
        re-check it on every call.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        #: perf_counter origin — export rebases timestamps onto it
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._buf: List[Span] = []
        self._write = 0          # overwrite cursor once the buffer is full
        self.dropped = 0         # spans overwritten by ring wrap

    # -------------------------------------------------------------- recording
    def add(self, name: str, track: str, t_start: float, t_end: float,
            args: Optional[Dict[str, Any]] = None) -> None:
        """Record one completed span. ``t_end == t_start`` is an instant."""
        if not self.enabled:
            return
        span = (name, track, t_start, t_end, args)
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(span)
            else:
                self._buf[self._write] = span
                self._write = (self._write + 1) % self.capacity
                self.dropped += 1

    def instant(self, name: str, track: str, t: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a point event (a zero-duration span)."""
        if not self.enabled:
            return
        if t is None:
            t = time.perf_counter()
        self.add(name, track, t, t, args)

    @contextmanager
    def span(self, name: str, track: str,
             args: Optional[Dict[str, Any]] = None):
        """Context manager: record the wrapped block as one span."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, track, t0, time.perf_counter(), args)

    # ---------------------------------------------------------------- reading
    def spans(self) -> List[Span]:
        """A chronological (oldest-first) copy of the buffered spans."""
        with self._lock:
            return self._buf[self._write:] + self._buf[:self._write]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        """Drop every buffered span (the perf_counter origin is kept, so
        spans recorded before and after a clear stay on one clock)."""
        with self._lock:
            self._buf = []
            self._write = 0
            self.dropped = 0
