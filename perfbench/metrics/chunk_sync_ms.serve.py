"""The engine's wait at a decode chunk's token read-back
(``engine.chunk_sync_s``), mean over the window's cycles, in ms."""


def read(run):
    if run.obs is None or run.steps is not None:
        return None
    h = run.obs.get("engine.chunk_sync_s")
    if h is None:
        return None
    return 1e3 * h["mean"]
