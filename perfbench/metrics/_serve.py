"""Shared by the serve readers: the requests due in the window and the
nearest-rank percentile over them, a failed or unfinished one counted as
a miss (+inf)."""
import math


def window_requests(run):
    if run.steps is not None or not run.requests:
        return None
    return [q for q in run.requests if q.phase == "window"]


def p95(values):
    """Nearest-rank 95th percentile; None where it is a miss."""
    if not values:
        return None
    s = sorted(values)
    v = s[max(1, math.ceil(0.95 * len(s))) - 1]
    return v if math.isfinite(v) else None
