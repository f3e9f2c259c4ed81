"""Trace + stats export: Chrome trace-event JSON and a periodic stats line.

:func:`export_chrome_trace` serialises a :class:`repro_torch.obs.tracing.Tracer`
into the Chrome trace-event format (the JSON Perfetto and
``chrome://tracing`` load directly — the tfprof rendering path of the
source paper, §VI): every tracer track becomes one named thread row
(``"engine"`` first, then slot and pipeline-line tracks in natural order),
completed spans become ``"X"`` duration events, zero-duration spans become
``"i"`` instants, and the metrics registry snapshot rides along in
``otherData`` so one artifact carries the whole picture.

:class:`StatsLogger` is the terminal counterpart: a daemon thread that
prints ONE line per interval (token throughput over the window, queue
depth, resident rows, pool occupancy, preempt/stall counts, TTFT p50)
from the same registry — ``launch/serve.py --stats-interval``.
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import MetricsRegistry
from .tracing import TRACK_ENGINE, Tracer

__all__ = ["chrome_trace_events", "export_chrome_trace", "StatsLogger"]

_PID = 1  # single-process serve stack: one trace process row


def _track_sort_key(track: str):
    """engine first, then tracks in natural (slot2 < slot10) order."""
    if track == TRACK_ENGINE:
        return (0, "", 0)
    m = re.match(r"^(.*?)(\d+)$", track)
    if m:
        return (1, m.group(1), int(m.group(2)))
    return (1, track, -1)


def chrome_trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """Flatten the tracer's ring buffer into trace-event dicts.

    Timestamps are rebased onto the tracer's origin (``tracer.t0``) and
    expressed in microseconds, as the format requires. Metadata events
    name the process and one thread per track; ``thread_sort_index`` pins
    the engine track to the top of the Perfetto timeline.
    """
    spans = tracer.spans()
    tracks = sorted({track for _, track, _, _, _ in spans},
                    key=_track_sort_key)
    tids = {track: i for i, track in enumerate(tracks)}
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": "repro-serve"},
    }]
    for track, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": track}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"sort_index": tid}})
    for name, track, t_start, t_end, args in spans:
        ts = (t_start - tracer.t0) * 1e6
        ev: Dict[str, Any] = {"name": name, "ph": "X", "pid": _PID,
                              "tid": tids[track], "ts": ts,
                              "args": dict(args) if args else {}}
        if t_end > t_start:
            ev["dur"] = (t_end - t_start) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"          # instant scoped to its thread (track)
        events.append(ev)
    return events


def export_chrome_trace(path: str, tracer: Tracer,
                        metrics: Optional[MetricsRegistry] = None) -> str:
    """Write the Chrome-trace JSON object form to ``path`` and return it.

    ``otherData`` carries the metrics snapshot plus the tracer's drop
    count, so a wrapped ring buffer is visible in the artifact rather
    than silently truncating history.
    """
    other: Dict[str, Any] = {"spans": len(tracer),
                             "dropped_spans": tracer.dropped}
    if metrics is not None:
        other["metrics"] = metrics.snapshot()
    payload = {
        "traceEvents": chrome_trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": other,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


class StatsLogger:
    """Periodic one-line serve stats from a :class:`MetricsRegistry`.

    Counters are reported as deltas over the interval window (so the
    throughput column is a live rate, not a lifetime mean); gauges and
    histogram percentiles are instantaneous. ``emit`` defaults to
    ``print`` — pass a callable to capture lines in tests.
    """

    #: counters whose per-window deltas feed the line
    _DELTAS = ("serve.tokens_out", "serve.requests.retired",
               "serve.requests.preempted", "serve.requests.stalled")

    def __init__(self, metrics: MetricsRegistry, interval: float = 1.0,
                 emit: Optional[Callable[[str], None]] = None) -> None:
        if interval <= 0:
            raise ValueError("stats interval must be > 0")
        self.metrics = metrics
        self.interval = interval
        self._emit = emit or (lambda line: print(line, flush=True))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Dict[str, int] = {}
        self._prev_t = time.perf_counter()

    # --------------------------------------------------------------- the line
    def line(self) -> str:
        """Format one stats line from the current snapshot (advances the
        delta window)."""
        now = time.perf_counter()
        dt = max(now - self._prev_t, 1e-9)
        snap = self.metrics.snapshot()
        delta = {}
        for name in self._DELTAS:
            cur = int(snap.get(name, 0) or 0)
            delta[name] = cur - self._prev.get(name, 0)
            self._prev[name] = cur
        self._prev_t = now
        ttft = snap.get("serve.ttft_s") or {}
        return (f"[obs] tok/s {delta['serve.tokens_out'] / dt:8.1f} | "
                f"retired {delta['serve.requests.retired']} | "
                f"queue {int(snap.get('serve.queue_depth', 0) or 0)} | "
                f"resident {int(snap.get('serve.resident_rows', 0) or 0)} | "
                f"blocks free/used/deferred "
                f"{int(snap.get('pool.blocks_free', 0) or 0)}/"
                f"{int(snap.get('pool.blocks_used', 0) or 0)}/"
                f"{int(snap.get('pool.blocks_deferred', 0) or 0)} | "
                f"preempt {delta['serve.requests.preempted']} "
                f"stall {delta['serve.requests.stalled']} | "
                f"ttft_p50 {1e3 * ttft.get('p50', 0.0):.0f}ms")

    # -------------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._emit(self.line())

    def start(self) -> "StatsLogger":
        if self._thread is not None:
            raise RuntimeError("stats logger already started")
        self._prev_t = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-obs-stats", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_line: bool = True) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        if final_line:
            self._emit(self.line())
