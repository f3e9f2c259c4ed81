"""Tokens of every optimizer step of the window over the window's wall
time (all its steps together, the trainer's own run included)."""


def read(run):
    s = run.steps
    if s is None:
        return None
    return s["n"] * s["tokens"] / s["wall_s"]
