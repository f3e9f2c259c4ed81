"""Share of the traced span with no operation running on the device, in
%."""


def read(run):
    if run.profile is None or run.steps is not None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.window_s)
