"""The (pixel, face) pairs kernels #1-3 need in one step, counted as the
roofline counts them (``portbench/roofline/dibr.py``, by the reference's
own code and that module's functions): #1 needs the pairs with the pixel
centre in a valid face's closed box, #2 and #3 each those with an
uncovered pixel centre in a face's enlarged, half-open box. The share of
the pairs the kernels visit that they need reads these against the port's
pair counters.
"""

import torch

from portbench.reference import dibr as ref
from portbench.roofline.dibr import _box_pairs


def needed(cfg, inputs, params):
    """(p1, p2): the pairs #1 needs and those #2 and #3 each need, over
    every camera of one step at ``params``."""
    soft = cfg["soft_mask"]
    mult, res = soft["multiplier"], cfg["res"]
    cams = ref.look_at_matrices(inputs["cam_pos"], inputs["look_at"],
                                inputs["up"])
    proj = ref.projection(inputs["fovy"], torch.float32, cams.device)
    with torch.no_grad():
        v = ref.posed_vertices(inputs["template"], params)
        fvz, fvi, nz = ref.prepare_vertices(v[None], inputs["faces"], proj,
                                            cams)
        fvi = fvi * mult
        valid = nz >= 0.0
        ids = ref.winner_search(fvz, fvi, valid, res, res, mult,
                                cfg["reference_pairs"])
    margin = soft["boxlen"] * mult
    p1 = p2 = 0
    for i in range(fvz.shape[0]):
        p1 += int(_box_pairs(fvi[i], res, res, mult, 0.0, True)[valid[i]]
                  .sum())
        p2 += int(_box_pairs(fvi[i], res, res, mult, margin, False,
                             ids[i] < 0).sum())
    return p1, p2


def needed_per_step(cfg, inputs, geometry):
    """The pairs #1-3 need in one step (p1 + 2·p2), the mean over the
    parameters in ``geometry`` (the traced window's start and end)."""
    counts = [needed(cfg, inputs, p) for p in geometry]
    return sum(p1 + 2 * p2 for p1, p2 in counts) / len(counts)
