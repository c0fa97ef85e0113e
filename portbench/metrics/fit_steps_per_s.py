"""Fit steps completed in the window over the window's length, which ends
in a synchronize (host clock)."""


def read(run):
    return run.steps / run.window_s
