"""Kernels #1-3's share of their roofline: the frozen bound of a step's
three launches over their device ms per step, %. The bound of each kernel
is the larger of its bytes over the card's HBM rate and its float32
operations over its float32 rate, counted from the cell's shapes and the
frozen pair counts of ``portbench/roofline/dibr.py``, at the parameters at
the traced window's start and end (the mean)."""

from portbench.roofline import dibr


def read(run):
    if run.trace is None:
        return None
    ms = dibr.kernels_ms(run.trace)
    if ms <= 0:
        return None
    bound = sum(dibr.bound_ms(run.cfg, run.inputs, p)
                for p in run.geometry) / len(run.geometry)
    return 100.0 * bound / ms
