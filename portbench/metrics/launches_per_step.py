"""Kernels, copies and fills that ran on the device in the traced window,
per step."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return run.trace.launches_per_step()
