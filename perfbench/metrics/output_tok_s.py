"""Output tokens delivered inside the window over the window's seconds: an
answer's tokens spread evenly from its first token to its finish."""
from pathlib import Path

from perfbench.harness import load_module

_s = load_module(Path(__file__).with_name("_serve.py"))


def read(run):
    if _s.window_requests(run) is None:
        return None
    w0, w1 = run.window
    n = 0
    for q in run.requests:
        k = q.n_out
        if q.first is None or q.finish is None or k < 1:
            continue
        step = (q.finish - q.first) / max(1, k - 1)
        n += sum(w0 <= q.first + step * i < w1 for i in range(k))
    return n / (w1 - w0)
