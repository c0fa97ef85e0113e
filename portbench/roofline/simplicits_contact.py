"""A Simplicits step with contact, frozen: its roofline bound from the
configuration's shapes and the work the traced window counted.

Objects o = 1..K of N_o points and H_o handles (D_o = 12 H_o DOFs), a
kinematic plate of P points, D = Σ D_o + 12 the scene's DOFs, m
line-search steps; L live contacts and I Newton iterations a step, read
from the port's counters over the traced window
(``physics.collision.contacts``, ``physics.simplicits.newton_iterations``),
so that the bound counts the work the scene's state asks for, whatever
implements the step. Each phase is bound by the larger of its float32
operations over the float32 rate and its bytes over the HBM rate
(``peaks.json``), each input read once and each output written once.

A step:

- detection: the points' positions and rest positions read once (6 floats
  a point), and each slot of the grid's occupied cells written once (8
  floats: position, rest position, object and id), M·K slots for M
  occupied cells of K slots (the scene's capacities);

each iteration:

- the elastic and point Hessians' reductions, object by object:
  2·D_o²·12N_o operations, dF/dz and B read (12 N_o D_o floats), the
  block written (D_o²);
- the gradient: the mat-vecs with dF/dz and B and their transposes,
  4·12 N_o D_o operations, the two matrices read;
- the line search's batch: the 2m + 1 step sizes' displacements and
  deformation gradients, 2·12 N_o D_o·(2m + 1) operations, the matrices
  read once;
- the contact terms of each live pair, whose LBS rows reach 2·4H_o
  factors a side-pair (4H_o·3 DOFs on each of its two objects, 24H_o in
  all): the reduced Hessian J_cᵀ H_c J_c, 2·(24H_o)²·3 operations; the
  gradient's pull-back and the offsets of the search's 2m + 2 energies,
  2·24H_o·3·(2m + 3); the per-pair 3 x 3 terms, 200; the pair's factors,
  normal and gap read (2·4H_o + 6 floats);
- the D x D Cholesky and LU (the contact graph solves by both):
  D³/3 + 2D³/3 + 4D² operations, H read twice and the solutions written.
"""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
with open(HERE / "peaks.json") as _f:
    PEAKS = json.load(_f)
FLOAT = 4
PAIR_TERM_OPS = 200


def _bound_s(nbytes, ops):
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["fp32_ops_per_s"])


def phases(cfg, live, iterations, occupied_cells, cell_capacity):
    """{phase: (bytes, operations)} of one step with ``live`` contacts and
    ``iterations`` Newton iterations."""
    k, n, h = cfg["cubes"], cfg["samples"], cfg["handles"]
    d_o, rows = 12 * h, 12 * n
    d = k * d_o + 12
    m = cfg["max_ls_steps"]
    n_all = k * n + cfg["plate_points"]
    side = 24 * h
    return {
        "detection": (FLOAT * (6 * n_all + 8 * occupied_cells
                               * cell_capacity), 0),
        "hessian": (iterations * k * FLOAT * (rows * d_o + d_o * d_o),
                    iterations * k * 2 * d_o * d_o * rows),
        "gradient": (iterations * k * FLOAT * rows * d_o,
                     iterations * k * 4 * rows * d_o),
        "line_search": (iterations * k * FLOAT * rows * d_o,
                        iterations * k * 2 * rows * d_o * (2 * m + 1)),
        "contacts": (iterations * live * FLOAT * (8 * h + 6),
                     iterations * live * (2 * side * side * 3
                                          + 2 * side * 3 * (2 * m + 3)
                                          + PAIR_TERM_OPS)),
        "solve": (iterations * FLOAT * (2 * d * d + 2 * d),
                  iterations * (d ** 3 + 4 * d * d)),
    }


def bound_ms(cfg, live, iterations, occupied_cells, cell_capacity):
    """The least time one step could take on the card, ms."""
    return 1e3 * sum(_bound_s(b, o) for b, o in phases(
        cfg, live, iterations, occupied_cells, cell_capacity).values())
