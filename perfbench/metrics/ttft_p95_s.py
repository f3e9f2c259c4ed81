"""95th percentile of the time to first token over every request due in
the window, timed from when it was due; a request refused or failed, or
without a first token when the wait past the window ended, is a miss."""
from pathlib import Path

from perfbench.harness import load_module

_s = load_module(Path(__file__).with_name("_serve.py"))


def read(run):
    reqs = _s.window_requests(run)
    if not reqs:
        return None
    return _s.p95([q.first - q.due
                   if q.first is not None and q.error is None
                   else float("inf") for q in reqs])
