"""The engine's host bookkeeping a decode cycle (``engine.book_s``: merge,
prefill windows, growth, retirement), mean over the window's cycles, in
ms."""


def read(run):
    if run.obs is None or run.steps is not None:
        return None
    h = run.obs.get("engine.book_s")
    if h is None:
        return None
    return 1e3 * h["mean"]
