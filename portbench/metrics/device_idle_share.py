"""The traced window's share in which no operation ran on the device:
1 − (union of the device's operations) / the window, from one trace, %."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
