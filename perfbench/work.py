"""What a serve cell's traffic asked of the chip inside a span of time,
from the requests' own shapes and the engine's timestamps of each request
(admitted, first token, finished): a prompt's tokens are spread evenly
between its admission and its first token, an answer's between its first
token and its finish."""
from __future__ import annotations

from typing import Iterator, Tuple


def span(run) -> Tuple[float, float]:
    """The traced span on the host's clock, or the window."""
    p = run.profile
    return (p.t0, p.t1) if p is not None else run.window


def decoded(run, a: float, b: float) -> Iterator[Tuple[object, int]]:
    """(request, keys attended) of every token a decode step produced in
    [a, b): an answer's token i >= 1 reads the prompt and i earlier
    tokens, its own key included (the first token comes from the
    prefill)."""
    for q in run.requests:
        n = q.n_out
        if q.first is None or q.finish is None or n < 2:
            continue
        step = (q.finish - q.first) / (n - 1)
        for i in range(1, n):
            if a <= q.first + step * i < b:
                yield q, q.prompt_len + i


def prefilled(run, a: float, b: float) -> Iterator[Tuple[object, int]]:
    """(request, position) of every prompt token prefilled in [a, b)."""
    for q in run.requests:
        if q.admitted is None or q.first is None:
            continue
        P = q.prompt_len
        step = (q.first - q.admitted) / P
        for t in range(P):
            if a <= q.admitted + step * (t + 1) < b:
                yield q, t


def admitted(run, a: float, b: float):
    """Requests admitted in [a, b) that went on to a first token."""
    return [q for q in run.requests if q.admitted is not None
            and q.first is not None and a <= q.admitted < b]
