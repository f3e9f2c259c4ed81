"""Serve-layer observability: span tracing, metrics, Perfetto export.

The Taskflow paper ships tfprof (§VI) — a built-in profiler whose
per-worker timelines make the runtime's scheduling decisions visible.
This package is the serve-stack analogue for our reproduction:

* :mod:`repro_torch.obs.tracing` — :class:`Tracer`, a thread-safe ring buffer
  of ``(name, track, t_start, t_end, args)`` spans (request lifecycle on
  per-slot tracks, engine cycle phases on the ``"engine"`` track,
  pipeline pipe bodies on ``"lineN"`` tracks);
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` of named counters,
  gauges and exponential-bucket histograms (pool occupancy, queue depth,
  preempt/stall counts, TTFT, queue wait, per-cycle dispatch/sync/
  bookkeeping seconds) with a JSON-able ``snapshot()``;
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON export (loads in
  Perfetto / ``chrome://tracing``) and the ``--stats-interval`` one-line
  :class:`StatsLogger`.

:class:`Observability` bundles one tracer + one registry and is what
``ServeEngine(obs=...)`` accepts; :func:`from_env` builds one when the
``REPRO_OBS`` environment variable is truthy (``1``/``true``/``yes``/
``on``), which is how the launcher and benchmarks opt in without
plumbing a handle through every constructor.
"""
from __future__ import annotations

import os
from typing import Optional

from .export import StatsLogger, chrome_trace_events, export_chrome_trace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import TRACK_ENGINE, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "TRACK_ENGINE",
    "StatsLogger", "chrome_trace_events", "export_chrome_trace",
    "Observability", "env_enabled", "from_env",
]

_TRUTHY = {"1", "true", "yes", "on"}


class Observability:
    """One tracer + one metrics registry, handed to ``ServeEngine(obs=)``.

    The engine treats a ``None`` obs handle as fully disabled (hot paths
    guard on a single attribute check), so constructing an
    ``Observability`` *is* the enable switch.
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_capacity: int = 65536) -> None:
        self.tracer = tracer if tracer is not None \
            else Tracer(capacity=trace_capacity)
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON artifact (spans + metric snapshot)."""
        return export_chrome_trace(path, self.tracer, self.metrics)

    def reset(self) -> None:
        """Clear spans and zero metrics in place (handles stay valid)."""
        self.tracer.clear()
        self.metrics.reset()


def env_enabled(env: Optional[str] = None) -> bool:
    """True when ``REPRO_OBS`` (or an explicit value) is truthy."""
    v = os.environ.get("REPRO_OBS", "") if env is None else env
    return v.strip().lower() in _TRUTHY


def from_env() -> Optional[Observability]:
    """An :class:`Observability` when ``REPRO_OBS`` opts in, else None."""
    return Observability() if env_enabled() else None
