"""Share of a step with no operation running on the device, in %: one
less the device's busy seconds a traced step over the seconds a step of
the untraced window took. The profiler slows the host's launches of the
traced steps (~130k a step), not the device's work, so their own wall
time would overstate the idle share."""


def read(run):
    s = run.steps
    if run.profile is None or s is None or "traced" not in s:
        return None
    busy = run.profile.busy_s() / s["traced"]["n"]
    return 100.0 * (1.0 - busy / (s["wall_s"] / s["n"]))
