"""95th percentile over every request due in the window of its time per
output token after the first, (finish - first token) / (tokens - 1), in
ms; a failed or unfinished request is a miss."""
from pathlib import Path

from perfbench.harness import load_module

_s = load_module(Path(__file__).with_name("_serve.py"))


def read(run):
    reqs = _s.window_requests(run)
    if not reqs:
        return None
    return _s.p95([1e3 * (q.finish - q.first) / (q.n_out - 1)
                   if q.ok and q.n_out > 1 else float("inf")
                   for q in reqs])
