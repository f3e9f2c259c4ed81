"""Set-up: the process's start to the window's open (weights, engine or
trainer, kernels built or loaded, warm-up, and the steps or arrivals
before the window)."""


def read(run):
    return run.setup_s
