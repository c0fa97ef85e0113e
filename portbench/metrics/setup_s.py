"""Seconds from the process's start to the first timed step: imports, the
card's context, the kernels loaded (built in a fresh checkout), the
inputs, the fit's set-up, its checked first steps and the warm-up."""


def read(run):
    return run.setup_s
