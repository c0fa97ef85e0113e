"""Kernels #1-3's work from a step's shapes, frozen: their device time by
name in a trace, and their roofline bound.

Each kernel's bound is the larger of the bytes it must move over the HBM
rate and its float32 operations over the float32 rate (``peaks.json``).
Bytes count each input once and each output once; operations count what
the plain versions compute per unit of work, at the pairs these inputs
need, counted here from the geometry by the reference's own code, so that
a share reads the same work whatever implements the kernels:

- #1, the winner search: a face's depths, image coordinates and valid flag
  (12 + 24 + 1 bytes) and a pixel's id (4); 21 operations a (pixel, face)
  pair with the pixel centre in the valid face's closed box (the
  barycentrics: 9 subtractions, 6 products, 3 additions, 3 divisions).
- #2, the soft mask's forward: a face's coordinates (24), a pixel's id
  read and its allprob written (4 + 4); 48 operations a face (an edge's
  A, B, C, their products and the denominator, 12 x 3 edges; the box 12)
  and 96 a pair with an uncovered pixel centre in the face's enlarged,
  half-open box (an edge's distance terms 24 x 3; a vertex's 5 x 3; the
  least of 6 candidates 5; p and its factor 4).
- #3, its backward: a face's coordinates read and its gradient written
  (24 + 24), a pixel's cotangent (4); 48 a face and 115 a pair at the
  uncovered pixels (the forward up to p, 94; 1 − p, the tie count, the
  cotangent and the cheapest candidate's VJP, 21).
"""

import json
from pathlib import Path

import torch

from portbench.reference import dibr as ref

HERE = Path(__file__).resolve().parent
with open(HERE / "peaks.json") as _f:
    PEAKS = json.load(_f)
with open(HERE / "device_names.json") as _f:
    DEVICE_NAMES = {k: tuple(v) for k, v in json.load(_f).items()
                    if k != "about"}
WINNER_OPS = 21
SOFT_FACE_OPS = 3 * 12 + 12
SOFT_FWD_OPS = 3 * 24 + 3 * 5 + 5 + 2 + 2
SOFT_BWD_OPS = SOFT_FWD_OPS - 2 + 1 + 11 + 4 + 5


def kernels_ms(trace):
    """Device ms per step of #1-3 with their helpers; 0 where the trace
    holds none of their main kernels."""
    mains = [names[0] for names in DEVICE_NAMES.values()]
    if trace.named_device_s(mains) <= 0:
        return 0.0
    return 1e3 * trace.named_device_s(
        [n for names in DEVICE_NAMES.values() for n in names])


def _box_pairs(fvi, height, width, multiplier, margin, closed, where=None):
    """(pixel, face) pairs with the pixel centre in a face's box of one
    view's ``fvi`` (F, 3, 2), enlarged by ``margin``; only at pixels where
    ``where`` (H, W) holds, when given → (F,) int64."""
    r0, nr, c0, nc = ref.box_ranges(fvi, margin, closed, height, width,
                                    multiplier)
    if where is None:
        return nr * nc
    table = torch.nn.functional.pad(where.long().cumsum(0).cumsum(1),
                                    (1, 0, 1, 0))
    r1, c1 = r0 + nr, c0 + nc
    return table[r1, c1] - table[r0, c1] - table[r1, c0] + table[r0, c0]


def bound_ms(cfg, inputs, params):
    """The bound of one step's three launches at ``params``, ms, over every
    camera of the step."""
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
    n, f = fvz.shape[:2]
    hw = res * res
    margin = soft["boxlen"] * mult
    p1 = p2 = 0
    for i in range(n):
        p1 += int(_box_pairs(fvi[i], res, res, mult, 0.0, True)[valid[i]]
                  .sum())
        p2 += int(_box_pairs(fvi[i], res, res, mult, margin, False,
                             ids[i] < 0).sum())
    work = ((n * (f * (12 + 24 + 1) + hw * 4), p1 * WINNER_OPS),
            (n * (f * 24 + hw * 8), n * f * SOFT_FACE_OPS + p2 * SOFT_FWD_OPS),
            (n * (f * 48 + hw * 4), n * f * SOFT_FACE_OPS + p2 * SOFT_BWD_OPS))
    return 1e3 * sum(max(nbytes / PEAKS["hbm_bytes_per_s"],
                                 ops / PEAKS["fp32_ops_per_s"])
                             for nbytes, ops in work)
