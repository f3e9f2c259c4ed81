"""95th percentile of the engine's queue wait (submit to admission,
``serve.queue_wait_s``) over the requests admitted in the window."""


def read(run):
    if run.obs is None or run.steps is not None:
        return None
    h = run.obs.get("serve.queue_wait_s")
    if h is None:
        return None
    return h["p95"]
