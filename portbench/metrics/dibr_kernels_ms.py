"""Device ms per step of kernels #1-3 (the winner search and the soft
mask's forward and backward, ``render/mesh/csrc``), their helper launches
included, by the frozen names of ``portbench/roofline/device_names.json``.
"""

from portbench.roofline import dibr


def read(run):
    if run.trace is None:
        return None
    ms = dibr.kernels_ms(run.trace)
    return ms if ms > 0 else None
