"""The share of the (pixel, face) pairs kernels #1-3 visit that a step
needs, %: the pairs needed (``roofline/dibr_pairs.py``, at the traced
window's parameters, the mean) over the pairs the kernels visited a step,
by the port's pair counters (their tile lists times the pixels they
evaluate; #3's faces' pixel ranges) over the window's steps."""

from portbench import program_trace
from portbench.roofline import dibr_pairs

PAIRS = ("render.mesh.winner.pairs", "render.mesh.soft_mask_fwd.pairs",
         "render.mesh.soft_mask_bwd.pairs")


def read(run):
    counts = program_trace.counters(run)
    if counts is None or not all(counts.get(n) for n in PAIRS) \
            or not run.geometry:
        return None
    visited = sum(counts[n] for n in PAIRS) / run.steps
    need = dibr_pairs.needed_per_step(run.cfg, run.inputs, run.geometry)
    return 100.0 * need / visited
