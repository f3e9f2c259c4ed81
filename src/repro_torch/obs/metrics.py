"""Named runtime metrics: counters, gauges, exponential-bucket histograms.

A :class:`MetricsRegistry` is the second half of the serve-layer
observability subsystem (spans in :mod:`repro_torch.obs.tracing` answer *when*,
these answer *how much*): the engine registers pool occupancy gauges,
preemption/stall counters and latency histograms (TTFT, queue wait, chunk
sync, per-cycle breakdown) against it, and :meth:`MetricsRegistry.snapshot`
returns one JSON-able dict the stats logger, the benchmarks and the trace
export all read.

Hot-path discipline: callers cache the metric HANDLE once
(``m = registry.counter("serve.tokens_out")``) and call ``m.inc()`` /
``m.record()`` per event — one lock + one arithmetic op; the registry dict
is only touched at registration time. Every metric zeroes IN PLACE on
:meth:`MetricsRegistry.reset` so cached handles survive a benchmark's
warm-up reset.

The histogram is exponential-bucketed (geometric bucket bounds — latencies
span µs to seconds, so linear buckets would waste either resolution or
range) and additionally retains up to ``keep_samples`` raw samples: for
the serve benchmarks' request counts the reported p50/p99 are EXACT, and
only beyond the retention cap do percentiles fall back to geometric
bucket interpolation.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins instantaneous value (pool occupancy, queue depth)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value: Union[int, float] = 0

    def set(self, v: Union[int, float]) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """Exponential-bucket histogram with exact small-count percentiles.

    Bucket ``0`` holds values below ``base``; bucket ``i >= 1`` holds
    ``[base * growth**(i-1), base * growth**i)``; the last bucket is
    open-ended. Defaults (10 µs base, ×2 growth, 40 buckets) cover
    10 µs .. ~5.5e6 s — every latency the serve stack can produce.
    """

    __slots__ = ("name", "base", "growth", "_lock", "_buckets", "_count",
                 "_sum", "_min", "_max", "_samples", "_keep")

    def __init__(self, name: str, base: float = 1e-5, growth: float = 2.0,
                 num_buckets: int = 40, keep_samples: int = 4096) -> None:
        if base <= 0 or growth <= 1.0 or num_buckets < 2:
            raise ValueError("histogram needs base > 0, growth > 1, "
                             ">= 2 buckets")
        self.name = name
        self.base = base
        self.growth = growth
        self._lock = threading.Lock()
        self._buckets = [0] * num_buckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: List[float] = []
        self._keep = keep_samples

    def _bucket_index(self, v: float) -> int:
        if v < self.base:
            return 0
        i = 1 + int(math.log(v / self.base) / math.log(self.growth))
        return min(i, len(self._buckets) - 1)

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._buckets[self._bucket_index(v)] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self._keep:
                self._samples.append(v)

    # ------------------------------------------------------------- summaries
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def buckets(self) -> List[int]:
        with self._lock:
            return list(self._buckets)

    def bucket_bound(self, i: int) -> float:
        """Exclusive upper bound of bucket ``i`` (inf for the last)."""
        if i >= len(self._buckets) - 1:
            return math.inf
        return self.base * self.growth ** i

    def percentile(self, q: float) -> float:
        """Value at percentile ``q`` (0..100): exact (nearest-rank over the
        retained samples) while every recorded value is retained, geometric
        bucket interpolation beyond the retention cap; 0.0 when empty."""
        if not 0.0 <= q <= 100.0:
            raise ValueError("percentile must be in [0, 100]")
        with self._lock:
            if self._count == 0:
                return 0.0
            if self._count <= len(self._samples):
                s = sorted(self._samples)
                rank = max(1, math.ceil(q / 100.0 * len(s)))
                return s[rank - 1]
            target = max(1, math.ceil(q / 100.0 * self._count))
            cum = 0
            for i, n in enumerate(self._buckets):
                cum += n
                if cum >= target:
                    lo = self.base * self.growth ** (i - 1) if i >= 1 \
                        else min(self._min, self.base)
                    hi = self.base * self.growth ** i if i >= 1 else self.base
                    hi = min(hi, self._max)
                    lo = min(lo, hi)
                    return math.sqrt(lo * hi) if lo > 0 else hi
            return self._max       # unreachable (cum == count at the end)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if count else 0.0
            mx = self._max if count else 0.0
        return {"count": count, "sum": total,
                "mean": total / count if count else 0.0,
                "min": mn, "max": mx,
                "p50": self.percentile(50.0), "p99": self.percentile(99.0)}

    def reset(self) -> None:
        with self._lock:
            self._buckets = [0] * len(self._buckets)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._samples = []


class MetricsRegistry:
    """Get-or-create registry of named metrics (thread-safe).

    ``counter("x")`` / ``gauge("x")`` / ``histogram("x")`` return the live
    metric, creating it on first use; re-registering a name as a different
    kind raises. :meth:`snapshot` returns ``{name: value-or-summary}`` and
    :meth:`reset` zeroes every metric in place (handles stay valid).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get_or_create(name, Histogram, **kw)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict: counters/gauges -> value, histograms ->
        their :meth:`Histogram.summary` dict."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in sorted(items):
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        """Zero every metric IN PLACE — cached handles keep working (the
        benchmark warm-up reset)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()
