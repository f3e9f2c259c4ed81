"""The device trace of a run's traced span: ``torch.profiler``'s device
activity (kernels, copies and fills), read from its raw events.

* :meth:`Profile.busy_s`: the seconds in which an operation ran on the
  device (the union of the events' intervals), over the span;
* :meth:`Profile.kernel_s`: the summed device time of the named kernels
  (a roofline's time);
* :meth:`Profile.breakdown`: the operations that took most time, and the
  longest idle gaps by what the host was doing then (the engine's spans,
  where the run keeps them).

The host's clock and the trace's are tied by a marker kernel launched on
a stream of its own when the span opens.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"     # torch.cuda._sleep's kernel; the program has none


class Profile:
    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self._events: Optional[List[Tuple[str, int, int]]] = None
        self._t_mark = None

    @staticmethod
    def warm(device: torch.device) -> None:
        """Start and stop the profiler once, so the span's own start is
        quick (the first start loads the tracing library)."""
        p = Profile(device)
        p.start()
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        p.stop()

    def start(self) -> None:
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        s = torch.cuda.Stream(self.device)
        with torch.cuda.stream(s):
            self._t_mark = time.perf_counter()
            torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def events(self) -> List[Tuple[str, int, int]]:
        """(name, start ns, duration ns) of every device event, the marker
        left out, in the trace's clock, cut to the span (the work queued
        before the span closed runs on after it)."""
        if self._events is None:
            raw, cuda = [], torch.autograd.DeviceType.CUDA
            self._mark_ns = None
            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() != cuda:
                    continue
                name = e.name()
                if MARKER in name:
                    self._mark_ns = e.start_ns()
                    continue
                raw.append((name, e.start_ns(), e.duration_ns()))
            lo, hi = -1 << 62, 1 << 62
            if self._mark_ns is not None:
                lo = self._mark_ns - int((self._t_mark - self.t0) * 1e9)
                hi = self._mark_ns + int((self.t1 - self._t_mark) * 1e9)
            ev = []
            for name, st, d in raw:
                a, b = max(st, lo), min(st + d, hi)
                if b > a:
                    ev.append((name, a, b - a))
            ev.sort(key=lambda x: x[1])
            self._events = ev
        return self._events

    def host_time(self, ns: int) -> Optional[float]:
        """A trace timestamp on the host's clock (perf_counter)."""
        self.events()
        if self._mark_ns is None:
            return None
        return self._t_mark + (ns - self._mark_ns) / 1e9

    def _busy(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, d in self.events():
            e = s + d
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) / 1e9

    def kernel_s(self, kernels: Sequence[str]) -> Tuple[float, int]:
        """(summed seconds, launches) of the kernels whose function is one
        of ``kernels`` (the name before its template arguments)."""
        pat = re.compile(r"\b(%s)[<(]" % "|".join(map(re.escape, kernels)))
        tot, n = 0, 0
        for name, _, d in self.events():
            if pat.search(name):
                tot += d
                n += 1
        return tot / 1e9, n

    def breakdown(self, run) -> Dict[str, list]:
        by = defaultdict(int)
        for name, _, d in self.events():
            by[name[:160]] += d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        busy = self._busy()
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                       for i in range(len(busy) - 1)), reverse=True)[:10]
        spans = _host_spans(run)
        idle = []
        for g, at in gaps:
            t = self.host_time(at + g // 2)
            idle.append([_label(spans, t), g / 1e9])
        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": idle}


def _host_spans(run) -> List[Tuple[str, float, float]]:
    tr = getattr(run, "tracer", None)
    if tr is None:
        return []
    return [(s[0], s[2], s[3]) for s in tr.spans() if s[1] == "engine"]


def _label(spans, t: Optional[float]) -> str:
    """The innermost engine span the host was in at ``t``."""
    if t is None or not spans:
        return "unattributed"
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return f"host: {best[0]}" if best else "host: outside any engine span"
