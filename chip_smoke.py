#!/usr/bin/env python3
"""Run the PyTorch port's five paths on one NVIDIA GPU and check them:
the DIB-R inverse-rendering step, the SPC first-hit raster, the
primitive-cost probe with its table-gather kernel, the Simplicits sim
step (config 1) and Simplicits contact (``bench.py``'s ``collision_10k``;
both plain PyTorch: the JAX package has no kernel there).

    python3 chip_smoke.py

Imports ``kaolin_tpu_torch`` only (no jax, no ``kaolin_tpu``). Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``kaolin_tpu_torch/**/csrc/*.cu`` (sm_90a);
3. hold each kernel against its plain PyTorch version on the card: winner
   ids exactly, the soft-mask forward within 1e-5, the soft-mask backward
   within 1e-4 of the plain gradient's largest entry (the plain autograd
   sums in another order); at 100x72 with B = 2, at the config-2 shapes,
   on ``adversarial_faces`` (box edges on pixel centres, faces off the
   image, one face over the whole image), on config 2's sphere twice in
   one batch and on 100 faces over a whole 512x512 image (the plan's two
   passes and its larger bands; every tile's face list holds 100 faces);
   the winner and the forward also on 2,000 small faces in one 16x16 tile
   (each of its four 8x8 kernel tiles lists about 500 faces, more than
   the 256 a block stages at once). The forward given the
   rasterizer's ids (``face_idx``) bitwise equal to the forward without
   them at every uncovered pixel and 1.0 at every covered one, and bitwise
   equal across two launches; the backward bitwise equal across two
   launches on config 2. The SPC tile and untile kernels
   bitwise (depths) and exactly (ids), on a clustered level-5 octree at
   64² with 8-px tiles, on config 3 and on a camera inside config 3's
   shell with its grown capacities. The soft-mask backward also on a
   pixel centre 0.001 from an edge (``edge_pixel_faces``), where a
   cotangent there alone gives every face exactly 0 (fault F11); the
   JAX-style positional calls of ``dibr_rasterization`` and
   ``dibr_soft_mask`` equal the plain calls (F12); ``raster_first_hit``
   with 32-px tiles equals 16-px tiles at config 3 (F13);
4. the sim step on the card against the port's CPU step from the CPU's
   states, 10 steps at ``__graft_entry__``'s size and 3 at config 1, the
   displacement B z within 1e-4 of its largest entry (B z does not depend
   on the QR basis of z); TF32 off in every sim phase; contact on the card
   against the CPU: each broad phase's pair set and diagnostics on three
   seeded scenes of 3 x 400 points (grid and sweep equal to dense on both
   devices); at 5 states of the example's stack (2 x 300 points, a
   10 x 10 plate) the detection, the contact terms and the step's energy
   within 1e-4 (``check_stack_step`` says why its step is not held); and
   ``make_demo_scene``'s scene, 10 steps (5 for the sweep) from the CPU's
   states, B z within 1e-4 of max|B z| plus twice the card's own spread;
5. the DIB-R path: ``config2_step`` (512², a 4992-face UV sphere, forward
   and backward, 5 steps) with every launch counter set to 0 before and
   read after (each soft-mask forward given the rasterizer's ids), its
   first step held against the same step through the plain versions; then
   the 64² silhouette optimisation of
   ``examples/torch_dibr_optimization.py`` (final loss < 0.30, |shift| <
   0.05);
6. the SPC path: ``config3_frames`` of ``examples/torch_spc_raster.py``
   (a level-9 sphere shell, 512², 60 frames, capacities grown until no
   overflow), counters set to 0 before and read after; frame 0 held against
   the plain versions and against a brute-force slab test of every leaf on
   4,096 sampled pixels; then a camera inside the shell, whose slot
   overflow must clear as ``s_max`` grows;
7. the table gather's two routes (shared memory, L2) held bit for bit
   against ``table_gather_plain``: the probe's shape, 2^14 and 2^20
   tables, 58,112 and 58,113 floats (either side of the route rule),
   negative and out-of-range indices, counts that are not a multiple of 4
   and unaligned views;
8. the probe path: ``primitives_bench.main([])`` at its full sizes, counters
   set to 0 before and read after; every probe printed its line, both
   gather routes launched, and ``correct`` is true; then config 1's 150
   steps eager (Newton stops early) and from a CUDA graph (fixed trip),
   counters set to 0 before and read after (the path has no kernel): the
   mean height falls and stays above the floor, nothing is NaN, no graph
   step runs again eagerly, and the two end within 1e-4 of max|z|; a scene
   with a kinematic object, moved mid-run, graph against eager; their
   steps/s (eager ``run_sim_step``, one graph replay, ``run_sim_steps(150)``
   eager and from the graph) are timed after the kernels, from a graph
   captured after earlier graphs were freed and replayed after their
   memory was filled with NaN (fault F14), held against eager from the same
   start; then ``collision_10k`` at full size (10,712 contact particles,
   the grid): steps and capacity checks until a 20-step window needs no
   resize, then 20 steps eager and 20 from the graph from one start,
   counters set to 0 before and read after (no kernel may launch): finite,
   the flags 0, pairs found, every cube above the floor, no graph step run
   again eagerly, graph against eager within 1e-4 of max|B z|; its steps/s
   (eager ``run_sim_step``, one replay, ``run_sim_steps(20)``);
9. time each kernel and each path against the plain versions with CUDA
   events, in the order plain, kernel, kernel, plain;
10. ``torch.profiler`` (``kaolin_tpu_torch.utils.profiling.trace``) over 10
   config-2 steps and 10 config-3 frames after warm-up: each kernel's
   device ms and launches per step or frame, each path's device-busy and
   idle share; the gathers and the library calls beside the kernels
   (``library_ms``), warm, at the probe's shapes; both gather routes on
   tables of 2^10 to 58,112 floats, to show where the route rule belongs;
   the config-1 sim step and the collision_10k step eager and as a graph
   replay: device busy, idle share and the largest ops, and detection's
   share of the collision_10k step;
11. each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
   and its float32 operations over 67 TFLOP/s (H100 SXM data sheet), the
   operations counted from this run's inputs, a term that depends on the
   face alone once per face, for the soft-mask forward only the pairs at
   pixels the rasterizer leaves uncovered (beside the all-pixel count),
   and for the SPC tile kernel only the slab
   tests the walk needs (every unit box walked, the leaves of the units a
   ray enters nearer than its best, the level-3 boxes); then the kernels
   in the order in which to make them faster; and the config-1 sim step's
   bound, its dense products and factorizations over 67 TFLOP/s, at the
   graph's 5 Newton iterations and at the eager path's measured count; the
   collision_10k step's, the same products object by object plus the
   contact terms at this run's contact count and the grid's pair tests.

Prints a JSON line with each kernel's launches, error, times and bound, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, without
that line, when there is no CUDA device or any phase fails.
"""

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 512
STEPS = 5
# config 3: level, resolution, frames; pixels of the brute-force check
SPC_LEVEL = 9
SPC_RES = 512
SPC_FRAMES = 60
ORACLE_PIXELS = 4096
INSIDE_EYE = (0.05, 0.02, 0.04)
# the table gather at the TPU probe's shape: (8192, 128) int32 indices into a
# 2^20-float table (L2 route) and into a 2^14-float one (shared memory)
GATHER_IDX = (8192, 128)
GATHER_TABLES = {"table_gather_l2": 1 << 20, "table_gather_smem": 1 << 14}
# tables up to the shared-memory route's largest, both routes timed on each
GATHER_SWEEP = (1 << 10, 1 << 12, 1 << 14, 1 << 15, 40_000, 58_112)
PROFILE_STEPS = 10
# the Simplicits sim step: states compared per step at the graft size and
# at config 1; B z within SIM_Z_TOL of max|B z| (card against CPU), z
# within SIM_Z_TOL of max|z| (graph against eager)
SIM_PARITY_STEPS = {"graft": 10, "config1": 3}
SIM_Z_TOL = 1e-4
SIM_TIMED_STEPS = 30
# contact: three seeded scenes of 3 x 400 points for the broad phases; the
# example's stack at 2 x 300 points over a 10 x 10 plate (5 states) and
# make_demo_scene's scene (10 steps a broad phase, 5 for the sweep) for the
# step; collision_10k at full size for 20 steps eager and 20 from the graph
COLLISION_SEEDS = (0, 1, 2)
COLLISION_STACK = dict(objects=2, qp=300, plate_side=10)
COLLISION_PARITY_STEPS = 5
COLLISION_DEMO = dict(num_qp=48, kinematic_qp=25, max_contact_pairs=512)
COLLISION_DEMO_STEPS = {"dense": 10, "grid": 10, "sweep": 5}
COLLISION_STEPS = 20
COLLISION_TIMED_STEPS = 10
COLLISION_PROFILE_STEPS = 4
TRACE_DIR = os.path.join(ROOT, "build", "traces")
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# float32 operations per unit of work, counted from the plain versions:
# rasterization._barycentrics per (pixel, face) pair in the closed box (9
# subtractions, 6 products, 3 additions, 3 divisions)
WINNER_OPS = 21
# dibr._edge_vertex_sqdist, each term counted once where it is first needed
# and each shared subexpression once. Per face, what depends on the face
# alone: an edge's A, B (1 each), C (3), A·A, B·B, A·B, A·C, B·C (1 each)
# and A·A + B·B + EPS (2), 12 x 3 edges; the box, 8 min/max and 4 for the
# margin
SOFT_FACE_OPS = 3 * 12 + 12
# per (pixel, face) pair in the enlarged box: an edge's up (4), x3 and y3
# (4 and a division each), direct (7), perp = up·up / den (2) and the
# compare (1), 24 x 3 edges; a vertex's squared distance, 5 x 3; the least
# of 6 candidates, 5; p = exp(c·d2) with c = -sigmainv / mult² once a call
# (2), 1 - p and the product (2)
SOFT_FWD_OPS = 3 * 24 + 3 * 5 + 5 + 2 + 2
# the backward recomputes the forward up to p (94), then its VJP at the
# least: 1 - p (1), the tie count (6 compares, 5 additions), the cotangent
# g·(k·p) / ((1 - p)·ties) (4), and the cheapest candidate's VJP, a vertex's
# (5: -2c, its products with dx and dy, their sums into the face gradient)
SOFT_BWD_OPS = SOFT_FWD_OPS - 2 + 1 + 11 + 4 + 5
# raster._slab per (pixel, leaf) test: 6 subtractions, 6 products, 6
# min/max per axis pair, 4 for entry and exit, the clamp and the compare
SLAB_OPS = 24

KERNELS = {
    "winner": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/rasterize.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_rasterize.py:37",
    },
    "soft_mask_fwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:180",
    },
    "soft_mask_bwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:207",
    },
    "spc_raster": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/spc/csrc/raster.cu",
        "replaces": "kaolin_tpu/render/spc/raster.py:324",
    },
    "spc_untile": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/spc/csrc/raster.cu",
        "replaces": "kaolin_tpu/render/spc/raster.py:614",
    },
    "table_gather_smem": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/utils/csrc/gather.cu",
        "replaces": "kaolin_tpu/utils/primitives_bench.py:135",
    },
    "table_gather_l2": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/utils/csrc/gather.cu",
        "replaces": "kaolin_tpu/utils/primitives_bench.py:135",
    },
}
DIBR_KERNELS = ("winner", "soft_mask_fwd", "soft_mask_bwd")
SPC_KERNELS = ("spc_raster", "spc_untile")
GATHER_KERNELS = ("table_gather_smem", "table_gather_l2")
# the kernels' names in a torch.profiler trace: the kernel whose launches
# are counted, then the helper launches whose time is the kernel's too
DEVICE_NAMES = {"winner": ("winner_kernel", "winner_box_kernel"),
                "soft_mask_fwd": ("soft_fwd_kernel", "soft_fwd_box_kernel"),
                "soft_mask_bwd": ("soft_bwd_kernel", "soft_bwd_count_kernel",
                                  "soft_bwd_plan_kernel",
                                  "soft_bwd_sum_kernel"),
                "spc_raster": ("raster_tiles_kernel",),
                "spc_untile": ("untile_kernel",),
                "table_gather_smem": ("gather_smem_kernel",),
                "table_gather_l2": ("gather_l2_kernel",)}
# every line the full probe prints, in order
PROBE_NAMES = (
    "gather1d_n65536_tab1048576", "gather1d_n1048576_tab1048576",
    "gather1d_n4194304_tab1048576", "gather1d_n4194304_tab16384",
    "rowgather_r8_n262144", "rowgather_r64_n262144", "scatter_add_n1048576",
    "scatter_min_n1048576", "scatter_set_unique_n1048576", "sort_kv_n262144",
    "sort_kv_n1048576", "sort_kv_n4194304", "rowsort128_r262144",
    "cumsum_n4194304", "table_gather_n1048576_tab1048576",
    "table_gather_n1048576_tab16384")
ENTRY_KEYS = ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms",
              "bound_by", "library_ms")


def adversarial_faces():
    """Scaled faces (2, 36, 3, 2) float32 at 72x100 for the soft mask with
    multiplier 1000 and boxlen 0.02 (margin 20), and a seeded cotangent on
    allprob (2, 72, 100): per batch element 24 random faces, some partly
    off the image; 6 whose enlarged boxes have all four edges on pixel
    centres (the half-open test keeps the low edges and drops the high
    ones); 2 wholly off the image, 2 across its left and bottom edges; a
    point face on a pixel centre (tied candidates); and one face whose box
    covers the whole image (7,200 pixels, more than one band of the
    backward kernel)."""
    h, w, margin = 72, 100, np.float32(20.0)
    sx, sy = np.float32(1000.0 / w), np.float32(1000.0 / h)

    def cx(c):   # pixel centres as rasterization._pixel_coords rounds them
        return sx * np.float32(2 * c + 1 - w)

    def cy(r):
        return sy * np.float32(h - 2 * r - 1)

    def vertex(centre, sign):
        """A float32 v with fl(v - sign * margin) == centre exactly."""
        v = np.float32(centre + sign * margin)
        for _ in range(8):
            e = np.float32(v - sign * margin)
            if e == centre:
                return v
            v = np.nextafter(v, np.float32(np.inf if e < centre else -np.inf),
                             dtype=np.float32)
        raise AssertionError(f"no vertex puts an edge on {centre}")

    rng = np.random.RandomState(7)
    out = []
    for _ in range(2):
        faces = list(rng.randn(24, 3, 2).astype(np.float32) * 400)
        for _ in range(6):
            c, r = rng.randint(2, w - 12), rng.randint(2, h - 12)
            x0, x1 = vertex(cx(c), 1), vertex(cx(c + rng.randint(3, 9)), -1)
            y1, y0 = vertex(cy(r), -1), vertex(cy(r + rng.randint(3, 9)), 1)
            faces.append([[x0, y0], [x1, (y0 + y1) / 2], [(x0 + x1) / 2, y1]])
        faces += [[[1200, 100], [1400, 300], [1300, 500]],
                  [[-200, -1100], [300, -1300], [0, -1500]],
                  [[-1100, 0], [-900, 200], [-1050, 300]],
                  [[-100, -1050], [200, -900], [50, -1200]],
                  [[cx(40), cy(20)]] * 3,
                  [[-1100, -1100], [1100, -1050], [-1050, 1100]]]
        out.append(np.asarray(faces, np.float32))
    g = rng.randn(2, h, w).astype(np.float32)
    return np.stack(out), g, h, w


# the soft mask of edge_pixel_faces: a wide falloff, so that faces far from
# a pixel still weigh on it
EDGE_SIGMAINV, EDGE_BOXLEN = 70.0, 0.5


def edge_pixel_faces():
    """Scaled faces (1, 6, 3, 2) float32 at 16x16 for the soft mask with
    multiplier 1000 and ``EDGE_SIGMAINV``/``EDGE_BOXLEN``, a seeded
    cotangent on allprob (1, 16, 16) and the pixel (row, col) = (8, 8),
    whose centre (62.5, -62.5) lies 0.001 below the first face's lower
    edge: that face's d² is 1e-6, its p rounds to 1 and allprob there is 0,
    while d²'s gradient is not 0. The other five faces are seeded and
    overlap the pixel."""
    y = np.float32(-62.5 + 0.001)
    rng = np.random.RandomState(12)
    faces = [[[-237.5, y], [362.5, y], [62.5, 337.5]]]
    faces += list(rng.uniform(-700, 700, (5, 3, 2)))
    g = rng.randn(1, 16, 16).astype(np.float32)
    return np.asarray(faces, np.float32)[None], g, 16, 16, (8, 8)


def with_depth(fvi, seed):
    """Seeded z (B, F, 3) in [-3, -1] and a validity mask (B, F) with about
    one face in five culled, for the winner search on faces ``fvi``."""
    rng = np.random.RandomState(seed)
    b, f = fvi.shape[:2]
    return {"fvi": fvi,
            "fvz": rng.uniform(-3, -1, (b, f, 3)).astype(np.float32),
            "valid": rng.rand(b, f) > 0.2}


def dense_tile_faces():
    """2,000 small faces inside the top-left 16x16 tile of a 64x64 image and
    48 over the rest, scaled as for multiplier 1000, with z and validity:
    the face lists of its four 8x8 kernel tiles span several chunks and
    are run more than once."""
    rng = np.random.RandomState(5)
    # the tile's pixel centres span x in [-984.4, -515.6], y in [515.6, 984.4]
    c = np.concatenate([rng.uniform([-960, 540], [-540, 960], (2000, 2)),
                        rng.uniform(-1000, 1000, (48, 2))])
    fvi = c[:, None] + rng.uniform(-20, 20, (2048, 3, 2))
    return with_depth(fvi[None].astype(np.float32), 6), 64, 64


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def load_example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blob_points(seed=1, level=5):
    """The clustered random octree of tests/render/test_spc_raster.py: four
    blobs of 300 points and 100 points of dust, quantized at ``level``."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.6, 0.6, (4, 3)).astype(np.float32)
    pts = np.concatenate(
        [c + 0.12 * rng.randn(300, 3).astype(np.float32) for c in centers]
        + [rng.uniform(-1, 1, (100, 3)).astype(np.float32)])
    grid = 2 ** level
    return np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                             grid - 1), axis=0).astype(np.int16)


def contact_clouds(seed, n_per_obj=400, n_obj=3, spread=0.6):
    """``n_obj`` seeded clouds of ``n_per_obj`` points (side 0.6, centres
    in a box of side 2 * ``spread``) and a seeded displacement → (dx, x0,
    obj_ids), float32 and int32: the scenes of the broad-phase parity."""
    rng = np.random.RandomState(seed)
    pts, ids = [], []
    for o in range(n_obj):
        center = rng.uniform(-spread, spread, (3,))
        pts.append(center + rng.uniform(-0.3, 0.3, (n_per_obj, 3)))
        ids.append(np.full(n_per_obj, o))
    x0 = np.concatenate(pts).astype(np.float32)
    dx = rng.uniform(-0.05, 0.05, x0.shape).astype(np.float32)
    return dx, x0, np.concatenate(ids).astype(np.int32)


def pair_set(contacts):
    """The unordered valid pairs of a contact buffer."""
    c = contacts
    keep = c.valid.cpu().numpy()
    ia = c.indices_a.cpu().numpy()[keep]
    ib = c.indices_b.cpu().numpy()[keep]
    return set(zip(np.minimum(ia, ib).tolist(), np.maximum(ia, ib).tolist()))


class Smoke:
    def __init__(self):
        import torch

        from kaolin_tpu_torch.render.camera import Camera
        from kaolin_tpu_torch.render.mesh import (
            cuda_rasterize,
            cuda_soft_mask,
            dibr,
            rasterization,
        )
        from kaolin_tpu_torch.render.spc import cuda_raster, raster
        from kaolin_tpu_torch.utils import (
            cuda_build,
            cuda_gather,
            from_numpy_tree,
            primitives_bench,
            profiling,
        )

        self.torch = torch
        self.device = "cuda"
        self.cr, self.cs = cuda_rasterize, cuda_soft_mask
        self.dibr, self.rast = dibr, rasterization
        self.craster, self.sr = cuda_raster, raster
        self.cg, self.pb, self.profiling = (cuda_gather, primitives_bench,
                                            profiling)
        self.Camera = Camera
        self.cuda_build = cuda_build
        self.from_numpy_tree = from_numpy_tree
        self.ex = load_example("torch_dibr_optimization")
        self.spc_ex = load_example("torch_spc_raster")
        self.sim_ex = load_example("torch_simplicits_drop")
        self.col_ex = load_example("torch_collision_stack")
        self.col = {}   # collision_10k's scene and measurements
        from kaolin_tpu_torch.physics.common import Collision, optimization
        self.opt = optimization
        self.Collision = Collision
        self.newton = optimization.newtons_method
        self.sim = {}   # the sim step's measurements, for the bound
        self.failures = []
        self.results = {name: dict(meta) for name, meta in KERNELS.items()}
        self._config3 = None
        self.per_step = {}   # kernel -> launches per step or frame

    # -- helpers ---------------------------------------------------------
    def counters(self):
        return {"winner": self.cr.rasterize_search_cuda,
                "soft_mask_fwd": self.cs.soft_mask_fwd_cuda,
                "soft_mask_bwd": self.cs.soft_mask_bwd_cuda,
                "spc_raster": self.craster.raster_tiles_cuda,
                "spc_untile": self.craster.untile_cuda,
                "table_gather_smem": self.cg.table_gather_smem_cuda,
                "table_gather_l2": self.cg.table_gather_l2_cuda}

    def drive(self, names, path):
        """Run ``path`` with every launch counter set to 0 just before →
        (its result, the launches of the kernels ``names`` just after)."""
        for fn in self.counters().values():
            fn.launches = 0
        self.cs.soft_mask_fwd_cuda.launches_with_face_idx = 0
        out = path()
        self.torch.cuda.synchronize()
        return out, {k: self.counters()[k].launches for k in names}

    def check(self, ok, what):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def record_err(self, name, err):
        """Keep the largest error a kernel showed over the parity cases."""
        r = self.results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)

    def random_case(self):
        """64 random faces at 72x100 (ragged), B = 2: 16 faces culled
        (face_normals_z < 0), one with face_normals_z == 0 (kept), and two
        zero-area faces, a point on a pixel centre and a segment along a
        pixel row, which cover pixels only inside their bounding boxes."""
        rng = np.random.RandomState(0)
        tri = (rng.randn(2, 64, 3, 3) * 0.4).astype(np.float32)
        fvi = tri[..., :2] * np.float32(1000.0)
        # pixel centres as _pixel_coords rounds them: fl(1000 / n) * k
        x = np.float32(1000.0 / 100) * np.float32(2 * 60 + 1 - 100)
        y = np.float32(1000.0 / 72) * np.float32(72 - 2 * 30 - 1)
        fvi[:, 17] = [[x, y]] * 3
        fvi[:, 18] = [[-300.0, y], [100.0, y], [400.0, y]]
        nz = rng.randn(2, 64).astype(np.float32)
        nz[:, :16] = -1.0
        nz[:, 16] = 0.0
        nz[:, 17:19] = 1.0
        data = self.from_numpy_tree(
            {"fvz": tri[..., 2] - 2.0, "fvi": fvi, "valid": nz >= 0}, "cuda")
        return data, 72, 100

    def sphere_case(self, res):
        d = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        return ({"fvz": d["face_vertices_z"],
                 "fvi": (d["face_vertices_image"] * 1000.0).contiguous(),
                 "valid": d["face_normals_z"] >= 0}, res, res)

    def sphere_pair_case(self, res):
        """Config 2's sphere and a copy scaled by 0.9 as a batch of two:
        9,984 faces, more than the backward plan takes in one pass."""
        d, h, w = self.sphere_case(res)
        torch = self.torch
        return ({"fvz": torch.cat([d["fvz"], d["fvz"]]),
                 "fvi": torch.cat([d["fvi"], d["fvi"] * 0.9]).contiguous(),
                 "valid": torch.cat([d["valid"], d["valid"]])}, h, w)

    def screen_faces_case(self):
        """100 faces whose enlarged boxes each hold all of a 512x512 image,
        with edges across it, and a seeded cotangent: 6,400 bands of 4,096
        pixels outgrow the backward's 4,296 band slots, so its plan makes
        the bands twice as large."""
        rng = np.random.RandomState(3)
        r = rng.uniform(0, 200, (1, 100, 4)).astype(np.float32)
        t = rng.uniform(-1000, 1000, (1, 100, 2)).astype(np.float32)
        fvi = np.stack([np.stack([-1100 - r[..., 0], -1100 - r[..., 1]], -1),
                        np.stack([1100 + r[..., 2], t[..., 0]], -1),
                        np.stack([t[..., 1], 1100 + r[..., 3]], -1)], 2)
        g = rng.randn(1, 512, 512).astype(np.float32)
        return self.from_numpy_tree({**with_depth(fvi, 4), "g": g},
                                    "cuda"), 512, 512

    def soft_cotangent(self, d, h, w):
        """The cotangent on allprob that loss sum(soft²) gives, and
        allprob, for a case."""
        torch = self.torch
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)
            allprob = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                1000.0, h, w)
            g = torch.where(idx >= 0, 0.0, -2.0 * (1.0 - allprob))
        return g, allprob

    def time_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def compare_times(self, kernel_fn, plain_fn, reps, plain_reps):
        """Medians over plain, kernel, kernel, plain runs."""
        p = self.time_ms(plain_fn, plain_reps)
        k = self.time_ms(kernel_fn, reps)
        k += self.time_ms(kernel_fn, reps)
        p += self.time_ms(plain_fn, plain_reps)
        return statistics.median(k), statistics.median(p)

    # -- phases ----------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.card = card_line()
        print(f"card: {self.card}")
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device "
              f"{torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}", flush=True)

    def phase_build(self):
        cb = self.cuda_build
        print("building:", " ".join(cb.NVCC_FLAGS))
        for s in cb.sources():
            print("  source", os.path.relpath(s, ROOT))
        t0 = time.perf_counter()
        cb.library()
        print(f"built {os.path.relpath(cb.library_path(), ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def adversarial_case(self):
        fvi, g, h, w = adversarial_faces()
        return self.from_numpy_tree({**with_depth(fvi, 11), "g": g},
                                    "cuda"), h, w

    def forward_cases(self):
        """The winner search's and the soft-mask forward's parity cases:
        (label, (faces with z and validity, H, W))."""
        dense, h, w = dense_tile_faces()
        adv = self.adversarial_case()
        return [("random 72x100 B=2", self.random_case()),
                (f"sphere {RES}x{RES}", self.sphere_case(RES)),
                (f"adversarial {adv[1]}x{adv[2]} B=2", adv),
                (f"sphere pair {RES}x{RES} B=2", self.sphere_pair_case(RES)),
                ("100 faces over 512x512", self.screen_faces_case()),
                ("2,000 faces in one 16x16 tile",
                 (self.from_numpy_tree(dense, "cuda"), h, w))]

    def phase_parity(self):
        torch = self.torch
        for label, (d, h, w) in self.forward_cases():
            ids_k = self.cr.rasterize_search_cuda(d["fvz"], d["fvi"],
                                                  d["valid"], 1000, 1e-8, h, w)
            ids_p = self.rast.rasterize_search_plain(d["fvz"], d["fvi"],
                                                     d["valid"], 1000, 1e-8,
                                                     h, w)
            bad = int((ids_k != ids_p).sum())
            hits = int((ids_p >= 0).sum())
            self.check(bad == 0 and hits > 0,
                       f"winner ids exact [{label}]: {bad} of {ids_p.numel()}"
                       f" differ ({hits} covered)")
            self.record_err("winner", float((ids_k - ids_p).abs().max()))
            if label.startswith("random"):
                rows = torch.nonzero(ids_k == 18)[:, 1]
                self.check(bool((ids_k[:, 30, 60] == 17).all())
                           and rows.numel() > 0 and bool((rows == 30).all()),
                           f"zero-area faces stay in their boxes [{label}]")

            ap_k = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                              h, w)
            with torch.no_grad():
                ap_p = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                 1000.0, h, w)
            err = float((ap_k - ap_p).abs().max())
            self.check(err <= 1e-5 and float(ap_p.min()) < 0.99,
                       f"soft-mask forward within 1e-5 [{label}]: "
                       f"max abs err {err:.3e}")
            self.record_err("soft_mask_fwd", err)
            again = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                               h, w)
            same = torch.equal(again.view(torch.int32), ap_k.view(torch.int32))
            ap_i = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                              h, w, face_idx=ids_k)
            free = ids_k < 0
            kept = torch.equal(ap_i[free].view(torch.int32),
                               ap_k[free].view(torch.int32))
            ones = bool((ap_i[~free] == 1.0).all())
            self.check(same and kept and ones,
                       f"soft-mask forward bitwise across two launches "
                       f"{same}; with face_idx bitwise equal at "
                       f"{int(free.sum())} uncovered pixels {kept}, 1.0 at "
                       f"{int((~free).sum())} covered {ones} [{label}]")
        edge = self.edge_case()
        bwd_cases = [("random 72x100 B=2", self.random_case()),
                     ("sphere 128x128", self.sphere_case(128)),
                     (f"sphere {RES}x{RES}", self.sphere_case(RES)),
                     ("adversarial 72x100 B=2", self.adversarial_case()),
                     ("sphere pair 128x128 B=2", self.sphere_pair_case(128)),
                     ("100 faces over 512x512", self.screen_faces_case()),
                     ("a pixel centre 0.001 from an edge 16x16", edge)]
        for label, (d, h, w) in bwd_cases:
            soft = d.get("soft", (7000.0, 0.02))
            args = (*soft, 1000.0, h, w)
            if "g" in d:
                g = d["g"]
                with torch.no_grad():
                    allprob = self.dibr.soft_mask_plain(d["fvi"], *args)
            else:
                g, allprob = self.soft_cotangent(d, h, w)
            ga = (g * allprob).contiguous()
            grad_k = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
            grad_p = self.dibr._soft_mask_bwd_plain(d["fvi"], ga, *args)
            scale = float(grad_p.abs().max())
            err = float((grad_k - grad_p).abs().max())
            self.check(scale > 0 and err / scale <= 1e-4,
                       f"soft-mask backward within 1e-4 of max|grad| "
                       f"[{label}]: max abs err {err:.3e}, max|grad| "
                       f"{scale:.3e}, ratio {err / max(scale, 1e-30):.3e}")
            self.record_err("soft_mask_bwd", err)
            if label.startswith("sphere 512"):
                again = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
                same = torch.equal(again.view(torch.int32),
                                   grad_k.view(torch.int32))
                self.check(same, f"soft-mask backward bitwise equal across "
                           f"two launches [{label}]: {same}")
        d, h, w = edge
        r, c = d["pixel"]
        only = torch.zeros_like(d["g"])
        only[0, r, c] = 1.0
        args = (EDGE_SIGMAINV, EDGE_BOXLEN, 1000.0, h, w)
        with torch.no_grad():
            allprob = self.dibr.soft_mask_plain(d["fvi"], *args)
        ga = (only * allprob).contiguous()
        zero_k = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
        zero_p = self.dibr._soft_mask_bwd_plain(d["fvi"], ga, *args)
        self.check(float(allprob[0, r, c]) == 0.0
                   and not bool(zero_k.any()) and not bool(zero_p.any()),
                   "F11: a cotangent only where 1 - p rounds to 0 gives every"
                   " face exactly 0, kernel and plain: max "
                   f"{float(zero_k.abs().max()):.3e} and "
                   f"{float(zero_p.abs().max()):.3e}")
        self.check_jax_style_calls()
        torch.cuda.synchronize()

    def edge_case(self):
        fvi, g, h, w, pixel = edge_pixel_faces()
        d = self.from_numpy_tree({"fvi": fvi, "g": g}, "cuda")
        d["soft"], d["pixel"] = (EDGE_SIGMAINV, EDGE_BOXLEN), pixel
        return d, h, w

    def check_jax_style_calls(self):
        """F12: ``dibr_rasterization`` and ``dibr_soft_mask`` called with
        the JAX package's arguments in its positions, on the card: bit for
        bit the results of the calls without them."""
        torch = self.torch
        d = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        args = (RES, RES, d["face_vertices_z"], d["face_vertices_image"],
                d["face_features"], d["face_normals_z"])
        with torch.no_grad():
            want = self.dibr.dibr_rasterization(*args)
            got = self.dibr.dibr_rasterization(*args, 7000, 0.02, 30, None,
                                               None, "binned", 16, 512)
            mask = self.dibr.dibr_soft_mask(d["face_vertices_image"], want[2],
                                            7000, 0.02, 30, 1000.0, 16, 512,
                                            "pallas", "all")
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        self.check(same and torch.equal(mask, want[1]),
                   f"F12: JAX-style positional calls on the card equal the "
                   f"plain calls at config 2: {same}")

    def plain_loss(self, inputs, fvi, feats, res):
        """config2_loss with the plain versions in place of the kernels."""
        torch = self.torch
        scaled = fvi * 1000
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                inputs["face_vertices_z"], scaled.detach(),
                inputs["face_normals_z"] >= 0, 1000, 1e-8, res, res)
        img = self.rast._interpolate_at_winners(idx, scaled, feats, 1000,
                                                1e-8)
        allprob = self.dibr.soft_mask_plain(scaled, 7000, 0.02, 1000.0, res,
                                            res)
        soft = torch.where(idx >= 0, 1.0, 1.0 - allprob)
        return torch.sum(img ** 2) + torch.sum(soft ** 2)

    def phase_main_path(self):
        torch = self.torch
        out, launches = self.drive(
            DIBR_KERNELS,
            lambda: self.ex.config2_step("cuda", res=RES, steps=STEPS))
        print(f"config2_step {RES}x{RES}, {STEPS} steps: losses "
              f"{out['losses']}; launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"main path launched {k} ({n} times)")
        with_idx = self.cs.soft_mask_fwd_cuda.launches_with_face_idx
        self.check(with_idx == launches["soft_mask_fwd"],
                   f"main path gave the soft-mask forward the rasterizer's "
                   f"ids at {with_idx} of {launches['soft_mask_fwd']} launches")
        self.check(all(map(lambda x: x == x and abs(x) != float("inf"),
                           out["losses"])), "config-2 losses finite")
        for name in ("grad_fvi", "grad_feat"):
            g = out[name]
            self.check(bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0,
                       f"config-2 {name} finite and non-zero "
                       f"(max {float(g.abs().max()):.3e})")

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        lk, gvk, gfk = self.ex.config2_grad(inputs, fvi, feats, RES)
        lp, gvp, gfp = self.ex.config2_grad(inputs, fvi, feats, RES,
                                            loss_fn=self.plain_loss)
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        self.check(rel <= 1e-5, f"config-2 loss kernels vs plain: "
                   f"{float(lk):.6f} vs {float(lp):.6f} (rel {rel:.2e})")
        for name, a, b in (("fvi", gvk, gvp), ("features", gfk, gfp)):
            ratio = float((a - b).abs().max() / b.abs().max())
            self.check(ratio <= 1e-4, f"config-2 grad {name} kernels vs "
                       f"plain within 1e-4 of max: {ratio:.2e}")

        (losses, shift), counts1 = self.drive(
            DIBR_KERNELS, lambda: self.ex.main("cuda", res=64, iters=60))
        self.check(losses[-1] < 0.30 and abs(shift) < 0.05,
                   f"64x64 optimisation: final loss {losses[-1]:.4f} "
                   f"(< 0.30), shift {shift:+.4f} (|.| < 0.05); "
                   f"launches {counts1}")
        self.check(all(n > 0 for n in counts1.values()),
                   "64x64 optimisation ran through every kernel")

    def phase_timing(self):
        torch = self.torch
        print(f"timing on {self.card}", flush=True)
        d, h, w = self.sphere_case(RES)
        g, allprob = self.soft_cotangent(d, h, w)
        ga = (g * allprob).contiguous()
        ids = self.cr.rasterize_search_cuda(d["fvz"], d["fvi"], d["valid"],
                                            1000, 1e-8, h, w)
        pairs = {
            "winner": (
                lambda: self.cr.rasterize_search_cuda(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w),
                lambda: self.rast.rasterize_search_plain(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)),
            "soft_mask_fwd": (   # as the main path calls it, with the ids
                lambda: self.cs.soft_mask_fwd_cuda(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w, face_idx=ids),
                lambda: self.dibr.soft_mask_plain(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w, face_idx=ids)),
            "soft_mask_bwd": (
                lambda: self.cs.soft_mask_bwd_cuda(
                    d["fvi"], ga, 7000.0, 0.02, 1000.0, h, w),
                lambda: self.dibr._soft_mask_bwd_plain(
                    d["fvi"], ga, 7000.0, 0.02, 1000.0, h, w)),
        }
        for name, (kern, plain) in pairs.items():
            with torch.no_grad():
                k_ms, p_ms = self.compare_times(kern, plain, 20, 5)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name} at {h}x{w}, 4992 faces, B=1: kernel {k_ms:.4f} ms,"
                  f" plain {p_ms:.4f} ms", flush=True)
        every = statistics.median(self.time_ms(
            lambda: self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                               h, w), 20))
        print(f"soft_mask_fwd without face_idx (every pixel): kernel "
              f"{every:.4f} ms", flush=True)

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        k_ms, p_ms = self.compare_times(
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES),
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES,
                                         loss_fn=self.plain_loss), 10, 3)
        print(f"config-2 step (forward + backward) at {RES}x{RES}, 4992 "
              f"faces: kernels {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"[{self.card}]", flush=True)

    # -- the SPC raster ----------------------------------------------------
    def config3(self):
        """Config 3 built once: (rspc, camera, (tile_px, s_max, c_cap))."""
        if self._config3 is None:
            ex = self.spc_ex
            rspc, cam, _ = ex.build_scene(ex.config3_inputs(SPC_LEVEL),
                                          self.device, SPC_RES)
            caps, _ = ex.grow_caps(rspc, cam)
            self._config3 = rspc, cam, caps
        return self._config3

    def spc_camera(self, eye, res, fov):
        return self.Camera.from_args(
            eye=self.torch.tensor(eye), at=self.torch.zeros(3),
            up=self.torch.tensor([0.0, 1.0, 0.0]), fov=fov, width=res,
            height=res, device=self.device)

    def spc_bins(self, rspc, cam, caps):
        """The binning of one frame and the camera vector → dict of the
        tile kernel's inputs."""
        tile_px, s_max, c_cap = caps
        params = self.sr._prep_camera(cam)
        tab, counts, dz, ov = self.sr._bin_units(
            rspc.uaabb, *params, width=cam.width, height=cam.height,
            tile_h=tile_px, tile_w=tile_px, s_max=s_max, c_cap=c_cap)
        return {"tab": tab, "counts": counts, "dz": dz, "overflow": ov,
                "cam": self.sr._camera_vector(*params),
                "size": dict(width=cam.width, height=cam.height,
                             tile_px=tile_px)}

    def spc_tiles(self, kernel, rspc, b):
        fn = (self.craster.raster_tiles_cuda if kernel
              else self.sr.raster_tiles_plain)
        return fn(b["tab"], b["counts"], b["dz"], b["cam"], rspc.l3boxes,
                  rspc.units, rspc.uaabb, **b["size"])

    def spc_plain_frame(self, rspc, cam, caps):
        """raster_first_hit with the plain versions in place of the
        kernels."""
        b = self.spc_bins(rspc, cam, caps)
        depth, ids = self.sr.untile_plain(*self.spc_tiles(False, rspc, b),
                                          **b["size"])
        return self.sr._finish(depth, ids, b["overflow"])

    def spc_oracle(self, rspc, cam, pix):
        """Every leaf slab-tested against the rays of pixels ``pix``, with
        the raster's ray and slab formulas but no binning → (depth, id,
        leaf boxes by point-hierarchy id, first id), 3e38 and -1 on a
        miss."""
        torch, sr = self.torch, self.sr
        res = cam.width
        cam_vec = sr._camera_vector(*sr._prep_camera(cam))
        origin, inv = sr._rays(cam_vec, pix // res, pix % res, res,
                               cam.height)
        lanes = rspc.units.permute(0, 2, 1).reshape(-1, 8)
        lanes = lanes[lanes[:, 0] < 1.0e38].contiguous()
        ids = lanes[:, 6].contiguous().view(torch.int32)
        n = pix.shape[0]
        best = torch.full((n,), 3.0e38, device=pix.device)
        best_id = torch.full((n,), 2 ** 30, dtype=torch.int32,
                             device=pix.device)
        for s in range(0, lanes.shape[0], 8192):
            chunk = lanes[s:s + 8192]
            t_in, _, hit = sr._slab([chunk[:, k] for k in range(3)],
                                    [chunk[:, 3 + k] for k in range(3)],
                                    origin, [i[:, None] for i in inv])
            cand = torch.where(hit, t_in, 3.0e38)
            m = cand.amin(dim=1)
            sel = torch.where(cand == m[:, None], ids[None, s:s + 8192],
                              2 ** 30).amin(dim=1)
            best_id = torch.where(m < best, sel, torch.where(
                m == best, torch.minimum(best_id, sel), best_id))
            best = torch.minimum(best, m)
        first = int(ids.min())
        boxes = torch.empty((lanes.shape[0], 6), device=pix.device)
        boxes[(ids - first).long()] = lanes[:, :6]
        return best, torch.where(best < 1.0e38, best_id, -1), boxes, first

    def check_oracle(self, rspc, cam, t, nidx, label):
        """The raster's frame against the brute-force oracle on
        ORACLE_PIXELS pixels drawn with a seeded generator: equal hits,
        bitwise equal depths, and where the ids differ, a tie in depth."""
        torch = self.torch
        res = cam.width
        pix = torch.from_numpy(np.random.default_rng(0).choice(
            res * cam.height, ORACLE_PIXELS, replace=False)).to(self.device)
        depth_o, id_o, boxes, first = self.spc_oracle(rspc, cam, pix)
        t_r, id_r = t[pix], nidx[pix]
        hit_o, hit_r = depth_o < 1.0e38, torch.isfinite(t_r)
        same_hits = bool((hit_o == hit_r).all())
        bitwise = bool((t_r[hit_r].view(torch.int32)
                        == depth_o[hit_r].view(torch.int32)).all())
        differ = hit_r & (id_r != id_o)
        ties = True
        if bool(differ.any()):
            cam_vec = self.sr._camera_vector(*self.sr._prep_camera(cam))
            q = pix[differ]
            origin, inv = self.sr._rays(cam_vec, q // res, q % res, res,
                                        cam.height)
            box = boxes[(id_r[differ] - first).long()]
            t_in, _, hit = self.sr._slab([box[:, k] for k in range(3)],
                                         [box[:, 3 + k] for k in range(3)],
                                         origin, inv)
            ties = bool((hit & (t_in == depth_o[differ])).all())
        self.check(same_hits and bitwise and ties and int(hit_r.sum()) > 0,
                   f"SPC raster vs brute-force oracle [{label}], "
                   f"{ORACLE_PIXELS} pixels: {int(hit_r.sum())} hit, hits "
                   f"equal {same_hits}, depths bitwise {bitwise}, "
                   f"{int(differ.sum())} ids differ, all ties {ties}")

    def phase_spc_parity(self):
        torch = self.torch
        blobs = self.spc_ex.build_scene(
            {"points": blob_points(), "level": 5,
             "eye": np.float32([1.5, 0.9, -1.2]), "at": np.zeros(3, "f4"),
             "up": np.float32([0, 1, 0]), "fov": 0.9}, self.device, 64)[:2]
        caps, _ = self.spc_ex.grow_caps(*blobs, caps=(8, 16, 128))
        rspc3, cam3, caps3 = self.config3()
        inside = self.spc_camera(list(INSIDE_EYE), SPC_RES, 0.8)
        caps_in, _ = self.spc_ex.grow_caps(rspc3, inside)
        for label, (rspc, cam, caps) in (
                (f"blobs L5 64x64, caps {caps}", (*blobs, caps)),
                (f"config 3 L{SPC_LEVEL} {SPC_RES}x{SPC_RES}, caps {caps3}",
                 (rspc3, cam3, caps3)),
                (f"inside the shell {SPC_RES}x{SPC_RES}, caps {caps_in}",
                 (rspc3, inside, caps_in))):
            b = self.spc_bins(rspc, cam, caps)
            dk, ik = self.spc_tiles(True, rspc, b)
            dp, ip = self.spc_tiles(False, rspc, b)
            same = bool((dk.view(torch.int32) == dp.view(torch.int32)).all())
            bad = int((ik != ip).sum())
            hits = int((dp < 1.0e38).sum())
            self.check(same and bad == 0 and hits > 0 and
                       all(int(v) == 0 for v in b["overflow"].values()),
                       f"spc_raster vs plain [{label}]: depths bitwise "
                       f"{same}, {bad} ids differ, {hits} pixels hit")
            self.record_err("spc_raster", max(float((dk - dp).abs().max()),
                                              float((ik - ip).abs().max())))
            uk = self.craster.untile_cuda(dk, ik, **b["size"])
            up = self.sr.untile_plain(dk, ik, **b["size"])
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(uk, up))
            self.check(same, f"spc_untile vs plain [{label}]: bitwise {same}")
            self.record_err("spc_untile", max(
                float((uk[0] - up[0]).abs().max()),
                float((uk[1] - up[1]).abs().max())))
        # F13: a 32-px tile is split into 16-px ones on the card too
        kw = dict(s_max=caps3[1], c_cap=caps3[2])
        t32 = self.sr.raster_first_hit(rspc3, cam3, tile_px=32, **kw)
        t16 = self.sr.raster_first_hit(rspc3, cam3, tile_px=16, **kw)
        same = (torch.equal(t32[0].view(torch.int32),
                            t16[0].view(torch.int32))
                and torch.equal(t32[1], t16[1]) and bool(t32[2].any()))
        self.check(same, f"F13: raster_first_hit with tile_px 32 on the card"
                   f" equals tile_px 16 at config 3 bit for bit: {same}")
        torch.cuda.synchronize()

    def phase_spc_main_path(self):
        torch = self.torch
        out, launches = self.drive(SPC_KERNELS, lambda: self.spc_ex.
                                   config3_frames(self.device, SPC_RES,
                                                  SPC_FRAMES, SPC_LEVEL))
        t, nidx, valid = out["depth"], out["nidx"], out["valid"]
        print(f"config3_frames L{SPC_LEVEL} {SPC_RES}x{SPC_RES}, "
              f"{SPC_FRAMES} frames: caps (tile_px, s_max, c_cap) "
              f"{out['caps']}, overflow {out['overflow']}, "
              f"{int(valid[0].sum())} pixels hit; launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"main path launched {k} ({n} times)")
        self.check(all(v == 0 for v in out["overflow"].values()),
                   f"config-3 overflow after growth {out['overflow']}")
        hw = SPC_RES * SPC_RES
        self.check(t.shape == (SPC_FRAMES, hw) and nidx.shape == t.shape
                   and bool(valid.any(dim=1).all())
                   and bool(torch.isfinite(t[valid]).all())
                   and bool((t[valid] > 0).all())
                   and bool((nidx[~valid] == -1).all()),
                   f"config-3 frames of shape {tuple(t.shape)}: finite "
                   "positive depths where hit, -1 ids where missed")
        self.check(bool((t == t[0]).all() and (nidx == nidx[0]).all()),
                   "config-3 frames of one camera are identical")

        rspc, cam, caps = out["rspc"], out["camera"], out["caps"]
        tp, ip, vp, _ = self.spc_plain_frame(rspc, cam, caps)
        same = bool((t[0].view(torch.int32) == tp.view(torch.int32)).all()
                    and (nidx[0] == ip).all() and (valid[0] == vp).all())
        self.check(same, "config-3 frame 0 through the kernels equals the "
                   "plain frame bit for bit")
        self.check_oracle(rspc, cam, t[0], nidx[0], f"config 3 {SPC_RES}²")

        inside = self.spc_camera(list(INSIDE_EYE), SPC_RES, 0.8)
        caps_in, (ti, ii, vi, ov) = self.spc_ex.grow_caps(rspc, inside)
        tp, ip, vp, _ = self.spc_plain_frame(rspc, inside, caps_in)
        same = bool((ti.view(torch.int32) == tp.view(torch.int32)).all()
                    and (ii == ip).all())
        # the shell's random points leave some cells empty, so a few rays
        # escape: the oracle below checks each sampled pixel
        ov = {k: int(v) for k, v in ov.items()}
        self.check(caps_in[1] > caps[1] and same and bool(vi.any()),
                   f"camera inside the shell at {SPC_RES}²: caps grew to "
                   f"{caps_in}, overflow {ov}, {int(vi.sum())} pixels hit, "
                   f"kernels equal the plain frame {same}")
        self.check_oracle(rspc, inside, ti, ii, f"inside {SPC_RES}²")

    def phase_spc_timing(self):
        torch = self.torch
        print(f"timing on {self.card}", flush=True)
        rspc, cam, caps = self.config3()
        b = self.spc_bins(rspc, cam, caps)
        dt, it = self.spc_tiles(True, rspc, b)
        size = b["size"]
        bins_ms = statistics.median(self.time_ms(
            lambda: self.spc_bins(rspc, cam, caps), 20))
        print(f"SPC binning (plain torch) at config 3: {bins_ms:.4f} ms")
        pairs = {
            "spc_raster": (lambda: self.spc_tiles(True, rspc, b),
                           lambda: self.spc_tiles(False, rspc, b), 20, 3),
            "spc_untile": (lambda: self.craster.untile_cuda(dt, it, **size),
                           lambda: self.sr.untile_plain(dt, it, **size), 50,
                           20),
        }
        for name, (kern, plain, reps, plain_reps) in pairs.items():
            k_ms, p_ms = self.compare_times(kern, plain, reps, plain_reps)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name} at config 3 (L{SPC_LEVEL}, {SPC_RES}², caps "
                  f"{caps}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms",
                  flush=True)
        tile_px, s_max, c_cap = caps
        kw = dict(tile_px=tile_px, s_max=s_max, c_cap=c_cap)
        k_ms, p_ms = self.compare_times(
            lambda: self.sr.raster_first_hit(rspc, cam, **kw),
            lambda: self.spc_plain_frame(rspc, cam, caps), 20, 3)
        print(f"config-3 frame at {SPC_RES}²: kernels {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms [{self.card}]", flush=True)
        seq_ms = statistics.median(self.time_ms(
            lambda: self.sr.raster_first_hit_sequence(
                rspc, [cam] * SPC_FRAMES, **kw), 3))
        print(f"config-3 sequence of {SPC_FRAMES} frames at {SPC_RES}²: "
              f"{seq_ms:.4f} ms, {seq_ms / SPC_FRAMES:.4f} ms/frame "
              f"[{self.card}]", flush=True)

    # -- the table gather and the probe path ------------------------------
    def gather_case(self, n_tab, shape, lo=0, seed=0):
        """A random table of ``n_tab`` floats and int32 indices of ``shape``
        drawn from ``[lo, n_tab)``, on the card."""
        rng = np.random.RandomState(seed)
        table = rng.randn(n_tab).astype(np.float32)
        idx = rng.randint(lo, n_tab, shape).astype(np.int32)
        return self.from_numpy_tree((table, idx), self.device)

    def phase_gather_parity(self):
        torch, cg = self.torch, self.cg
        big = 1 << 20
        cases = [
            (f"probe shape {GATHER_IDX}, 2^20 table",
             self.gather_case(big, GATHER_IDX)),
            (f"{GATHER_IDX}, 2^14 table", self.gather_case(1 << 14,
                                                           GATHER_IDX)),
            ("58,112 floats, 2^20 indices",
             self.gather_case(cg.SMEM_MAX_FLOATS, (big,), seed=1)),
            ("58,113 floats, 2^20 indices",
             self.gather_case(cg.SMEM_MAX_FLOATS + 1, (big,), seed=2)),
            ("2^14 table, indices in [-2^15, 2^14) and past the end",
             self.gather_case(1 << 14, (big,), lo=-(1 << 15), seed=3)),
            ("2^20 table, 1,000,003 indices, negative ones too",
             self.gather_case(big, (1_000_003,), lo=-big, seed=4)),
            ("58,112 floats, 3 indices", self.gather_case(
                cg.SMEM_MAX_FLOATS, (3,), lo=-100, seed=5)),
        ]
        table, idx = self.gather_case(1 << 14, (4099,), lo=-(1 << 14), seed=6)
        cases.append(("unaligned views, 2^14 - 1 floats, 4,098 indices",
                      (table[1:], idx[1:])))
        for label, (table, idx) in cases:
            if "past the end" in label:
                idx = torch.where(idx % 7 == 0, idx + (3 << 14), idx)
            want = cg.table_gather_plain(table, idx)
            route = cg.gather_route(table.shape[0])
            fns = {"table_gather_l2": cg.table_gather_l2_cuda}
            if route == "smem":
                fns["table_gather_smem"] = cg.table_gather_smem_cuda
            for name, fn in fns.items():
                got = fn(table, idx)
                same = bool(torch.equal(got.view(torch.int32),
                                        want.view(torch.int32)))
                self.check(same and got.shape == idx.shape,
                           f"{name} vs plain [{label}]: bitwise {same}")
                self.record_err(name, float((got - want).abs().max()))
            before = {k: f.launches for k, f in self.counters().items()}
            cg.table_gather(table, idx)
            took = [k for k, f in self.counters().items()
                    if f.launches != before[k]]
            self.check(took == [f"table_gather_{route}"],
                       f"table_gather of {table.shape[0]} floats took "
                       f"{took}, the rule says {route}")
        torch.cuda.synchronize()

    # -- the Simplicits sim step ------------------------------------------
    def check_precision(self, label):
        """The sim step's float32 products run in full float32: TF32 off."""
        torch = self.torch
        tf32 = torch.backends.cuda.matmul.allow_tf32
        prec = torch.get_float32_matmul_precision()
        self.check(tf32 is False and prec == "highest",
                   f"{label}: matmul allow_tf32 {tf32}, float32 matmul "
                   f"precision {prec!r}")

    def sim_scene(self, which, device, **kw):
        ex = self.sim_ex
        make = ex.config1_scene if which == "config1" else ex.graft_scene
        return make(device, **kw)

    def phase_sim_parity(self):
        """The card's step against the port's CPU step from the same states:
        the CPU scene's trajectory, each state into the card's step.

        The scene sums its handle norms in float64, so both devices should
        take the same QR pivots, and then the CPU's state goes in as it is.
        Where they do not, a state crosses through the pre-QR basis in
        float64 (z_card = K_card⁻¹ K_cpu z_cpu). The steps are compared by
        their displacements B z, which do not depend on the basis."""
        torch = self.torch
        self.check_precision("phase_sim_parity")
        f64 = torch.float64
        for which, n in SIM_PARITY_STEPS.items():
            cpu = self.sim_scene(which, "cpu")
            states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
            for _ in range(n):
                cpu.run_sim_step()
                states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
            card = self.sim_scene(which, "cuda")
            oc, og = cpu.get_object(0), card.get_object(0)
            same = torch.equal(og.qr_tfm.cpu(), oc.qr_tfm)
            conv = og.qr_tfm_inv.cpu().to(f64) @ oc.qr_tfm.to(f64)
            fn, consts = card.build_functional_step()
            errs = []
            for k in range(n):
                z_in = [(x if same else (conv @ x.to(f64)).float()).cuda()
                        for x in states[k]]
                with torch.no_grad():
                    out = fn(consts, *z_in)
                got = card.sim_B.cpu().to(f64) @ out[0].cpu().to(f64)
                want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
                errs.append(float((got - want).abs().max()
                                  / want.abs().max()))
            raw = [(s.sim_B.cpu().to(f64) @ o.qr_tfm_inv.cpu().to(f64))
                   for s, o in ((card, og), (cpu, oc))]
            b_err = float((raw[0] - raw[1]).abs().max() / raw[1].abs().max())
            self.check(max(errs) <= SIM_Z_TOL and all(
                bool(torch.isfinite(x).all()) for x in states[-1]),
                f"sim step card vs CPU [{which}, D {card.total_dofs}, "
                f"{card.total_qp} points], {n} steps from the CPU's states: "
                f"max |d(B z)| / max|B z| {max(errs):.3e} (per step "
                + ", ".join(f"{e:.1e}" for e in errs)
                + f"); B K K^-1 {b_err:.1e} of max; the same QR pivots "
                f"{same} [{self.card}]")
        self.check_deferred_fallback()

    def check_deferred_fallback(self):
        """The graph's solve: a captured ``_direct_solve`` keeps the
        Cholesky solution and flags a failure; a scene whose graph step
        meets a failed Cholesky runs the step again eagerly."""
        torch, opt = self.torch, self.opt
        rng = torch.Generator().manual_seed(0)
        a = torch.randn(396, 396, generator=rng)
        g = torch.randn(396, generator=rng).cuda()
        flags = []
        for h in ((a @ a.T / 396 + torch.eye(396)).cuda(), (a + a.T).cuda()):
            failed = torch.zeros((), dtype=torch.bool, device="cuda")
            static = h.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), opt.cholesky_only(failed):
                opt._direct_solve(static, g)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), opt.cholesky_only(failed):
                out = opt._direct_solve(static, g)
            failed.zero_()
            graph.replay()
            chol = torch.cholesky_solve(
                g[:, None], torch.linalg.cholesky_ex(h.mT)[0])[:, 0]
            # the Cholesky of an indefinite H is not a solution: not compared
            flags.append((bool(failed),
                          bool(failed) or torch.equal(out, chol)))
        self.check(flags == [(False, True), (True, True)],
                   f"captured solve keeps the Cholesky and flags a failure "
                   f"(SPD, indefinite): {flags}")
        # z = 0.5·N(0, 1): every Cholesky of the step fails (info 50-51)
        z0 = 0.5 * torch.randn(396, generator=torch.Generator().manual_seed(1))
        eager = self.sim_scene("config1", "cuda")
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        for scene in (eager, graph):
            scene.sim_z = z0.to("cuda")
            scene.run_sim_step()
        same = torch.equal(eager.sim_z.view(torch.int32),
                           graph.sim_z.view(torch.int32))
        self.check(graph.graph_steps_rerun == 1 and same,
                   f"graph step where the Cholesky fails: run again eagerly "
                   f"({graph.graph_steps_rerun} step), bit for bit the eager "
                   f"step {same}")

    def fill_freed_memory(self, scene):
        """Tensors of NaN at the sizes of the constants a scene's step holds
        (the 3x3 and D x D identities, the int64 DOF index): if the step's
        graph still read any of them after it was freed, the allocator would
        hand its memory to one of these (fault F14, a graph that read freed
        memory)."""
        torch, d = self.torch, scene.total_dofs
        shapes = ((3, 3),) * 64 + ((d, d),) * 16 + ((2 * d,),) * 64
        return [torch.full(s, float("nan"), device="cuda") for s in shapes]

    def kinematic_scene(self, graphs):
        """Two graft-style objects (64 points, 4 handles; 48 points, 3
        handles), the second kinematic and lifted, with gravity and the
        floor: the scene of ``test_two_objects_one_kinematic_match_jax``."""
        ex = self.sim_ex
        a, b = ex.graft_points(64, 4), ex.graft_points(48, 3)
        b["pts"] = b["pts"] * np.float32(0.5)
        lift = np.eye(4, dtype=np.float32)
        lift[1, 3] = -0.6
        scene = ex.SimplicitsScene(timestep=0.03, max_newton_steps=3,
                                   max_ls_steps=5, device="cuda",
                                   use_cuda_graphs=graphs)
        for p, kin, init in ((a, False, None), (b, True, lift)):
            scene.add_object(ex.SkinnedPhysicsPoints(
                pts=p["pts"], yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
                skinning_weights=p["w"], dwdx=p["dwdx"]),
                is_kinematic=kin, init_transform=init)
        scene.set_scene_gravity((0.0, 9.8, 0.0))
        scene.set_scene_floor(floor_height=-1.0)
        return scene

    def check_kinematic_graph(self):
        """A scene with a kinematic object from the CUDA graph against
        eager: 20 steps, the kinematic object moved by
        ``set_kinematic_object_transform`` after 10, freed memory filled
        after the capture."""
        torch = self.torch
        move = np.eye(4, dtype=np.float32)
        move[0, 3] = 0.2
        scenes = [self.kinematic_scene(graphs) for graphs in (False, True)]
        junk = []
        for k in range(20):
            if k == 10:
                for scene in scenes:
                    scene.set_kinematic_object_transform(1, move)
            for scene in scenes:
                scene.run_sim_step()
            if k == 0:
                junk = self.fill_freed_memory(scenes[1])
        (eager, graph), kin = scenes, scenes[0].obj_z_slices[1]
        err = float((eager.sim_z - graph.sim_z).abs().max()
                    / eager.sim_z.abs().max())
        same = torch.equal(eager.sim_z.view(torch.int32),
                           graph.sim_z.view(torch.int32))
        held = torch.equal(graph.sim_z[kin], graph.get_object(1).z)
        del junk
        self.check(err <= SIM_Z_TOL and graph.graph_steps_rerun == 0
                   and held and bool(torch.isfinite(graph.sim_z).all()),
                   f"kinematic scene (D {graph.total_dofs}, "
                   f"{len(graph.dyn_idx)} dynamic), 20 steps from the graph "
                   f"against eager: max |dz| / max|z| {err:.3e}, bit for "
                   f"bit {same}, {graph.graph_steps_rerun} steps run again "
                   f"eagerly, the kinematic DOFs at the scripted move {held}")

    def phase_sim_path(self):
        """Config 1 in full: 150 steps eager (Newton stops early) and from
        the CUDA graph (fixed trip), mean height read every 30 steps; then
        a scene with a kinematic object, graph against eager."""
        torch, ex = self.torch, self.sim_ex
        self.check_precision("phase_sim_path")
        runs = {}
        for label, graphs in (("eager", False), ("graph", True)):
            scene = self.sim_scene("config1", "cuda", use_cuda_graphs=graphs)
            heights = [ex.mean_height(scene)]

            def path():
                for _ in range(ex.STEPS // 30):
                    scene.run_sim_steps(30)
                    heights.append(ex.mean_height(scene))

            t0 = time.perf_counter()
            _, launches = self.drive((), path)
            wall = time.perf_counter() - t0
            counts = {k: f.launches for k, f in self.counters().items()}
            low = float(scene.get_object_deformed_pts(0)[:, 1].min())
            finite = all(bool(torch.isfinite(x).all()) for x in
                         (scene.sim_z, scene.sim_z_dot))
            print(f"config 1, {ex.STEPS} steps, {label}: {wall:.3f} s host "
                  f"wall with the first step's set-up, "
                  f"{scene.graph_steps_rerun} graph steps run again eagerly;"
                  f" mean heights "
                  + ", ".join(f"{h:.4f}" for h in heights)
                  + f"; lowest point {low:.4f}; kernel launches {counts} "
                  f"[{self.card}]", flush=True)
            self.check(finite and scene.current_sim_step == ex.STEPS
                       and heights[-1] < heights[0] - 0.3
                       and min(heights) > -1.0 and low > -1.1
                       and scene.graph_steps_rerun == 0,
                       f"config-1 {label} path: finite, the mean height fell "
                       f"from {heights[0]:.4f} to {heights[-1]:.4f} and "
                       f"stayed above the floor at -1 (lowest mean "
                       f"{min(heights):.4f}, lowest point {low:.4f}), "
                       f"{scene.graph_steps_rerun} steps run again eagerly "
                       f"(config 1 needs no LU)")
            runs[label] = scene
        za, zb = runs["eager"].sim_z, runs["graph"].sim_z
        err = float((za - zb).abs().max() / za.abs().max())
        same = torch.equal(za.view(torch.int32), zb.view(torch.int32))
        self.check(err <= SIM_Z_TOL, f"config-1 graph vs eager after "
                   f"{ex.STEPS} steps: max |dz| / max|z| {err:.3e}, bit for "
                   f"bit {same}")
        self.check_kinematic_graph()

    def phase_sim_timing(self):
        """Steps/s of config 1: eager ``run_sim_step``, one graph replay a
        step, ``run_sim_steps(150)`` eager and from the graph; CUDA-event
        medians. The graph scene is captured after the earlier phases'
        graphs were freed, and the memory their constants would free is
        filled with NaN before it replays (fault F14): its states are held
        against the eager scene's, which took the same steps from the same
        start, and a graph time is reported only from a run in which no
        step ran again eagerly."""
        torch, ex = self.torch, self.sim_ex
        self.check_precision("phase_sim_timing")
        eager = self.sim_scene("config1", "cuda")
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        graph.run_sim_step()       # the capture
        graph.reset_scene()
        junk = self.fill_freed_memory(graph)
        n = SIM_TIMED_STEPS
        before = self.newton.iterations
        e_ms = statistics.median(self.time_ms(eager.run_sim_step, n))
        iters = (self.newton.iterations - before) / (n + 1)
        g_ms = statistics.median(self.time_ms(graph.run_sim_step, n))
        single = (eager.sim_z, graph.sim_z)
        rerun_single = graph.graph_steps_rerun
        eager.reset_scene()
        graph.reset_scene()
        # 4 x 150 steps each from rest: a warm-up call, then 3 timed
        re_ms = statistics.median(self.time_ms(
            lambda: eager.run_sim_steps(ex.STEPS), 3))
        r_ms = statistics.median(self.time_ms(
            lambda: graph.run_sim_steps(ex.STEPS), 3))
        del junk
        rerun = graph.graph_steps_rerun
        errs = [float((a - b).abs().max() / a.abs().max()) for a, b in
                (single, (eager.sim_z, graph.sim_z))]
        same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in (single, (eager.sim_z, graph.sim_z))]
        self.check(max(errs) <= SIM_Z_TOL and rerun == 0,
                   f"config-1 timed graph scene against eager from the same "
                   f"start, after {n + 1} single steps and after "
                   f"{4 * ex.STEPS} steps of run_sim_steps({ex.STEPS}): max "
                   f"|dz| / max|z| {errs[0]:.3e}, {errs[1]:.3e}, bit for bit "
                   f"{same}; {rerun} of the graph's "
                   f"{n + 1 + 4 * ex.STEPS} steps run again eagerly "
                   f"({rerun_single} in the single steps)")
        self.sim.update(iterations=iters, dofs=eager.total_dofs,
                        points=eager.total_qp, newton=eager.max_newton_steps,
                        ls=eager.max_ls_steps)
        if rerun == 0:
            graph_line = (
                f"graph replay {g_ms:.4f} ms ({1e3 / g_ms:.1f} steps/s, "
                f"{eager.max_newton_steps} iterations); run_sim_steps"
                f"({ex.STEPS}) from the graph {r_ms:.4f} ms "
                f"({ex.STEPS * 1e3 / r_ms:.1f} steps/s)")
        else:
            graph_line = (f"graph times not reported: {rerun} steps ran "
                          f"again eagerly")
        print(f"config-1 sim step, the first {n} steps from rest, medians:"
              f" eager run_sim_step {e_ms:.4f} ms ({1e3 / e_ms:.1f} steps/s,"
              f" {iters:.2f} Newton iterations a step); {graph_line}; eager "
              f"run_sim_steps({ex.STEPS}) {re_ms:.4f} ms "
              f"({ex.STEPS * 1e3 / re_ms:.1f} steps/s) [{self.card}]",
              flush=True)

    # -- contact (collision_10k) ---------------------------------------------
    def qr_conv(self, card, cpu):
        """(z_card = conv @ z_cpu in float64, the same pivots): the
        block-diagonal K_card⁻¹ K_cpu, identity for objects without QR."""
        torch, f64 = self.torch, self.torch.float64

        def blocks(scene, name):
            return torch.block_diag(*(
                torch.eye(12 * o.num_handles, dtype=f64)
                if getattr(o, name) is None
                else getattr(o, name).cpu().to(f64)
                for o in scene.sim_obj_dict.values()))

        same = all(torch.equal(a.qr_tfm.cpu(), b.qr_tfm)
                   for a, b in zip(card.sim_obj_dict.values(),
                                   cpu.sim_obj_dict.values())
                   if a.qr_tfm is not None)
        return blocks(card, "qr_tfm_inv") @ blocks(cpu, "qr_tfm"), same

    def phase_collision_parity(self):
        """Contact on the card against the port's CPU version from the same
        inputs: each broad phase's pair set on three seeded scenes of 3 x 400
        points (and the grid's and the sweep's against the dense set on each
        device, the diagnostics equal); the stack scene's contact terms
        (``check_stack_step``); the demo scene's step, by B z
        (``check_demo_steps``)."""
        torch = self.torch
        self.check_precision("phase_collision_parity")
        Collision = self.Collision
        for seed in COLLISION_SEEDS:
            dx, x0, ids = contact_clouds(seed)
            sets, diags = {}, {}
            for bp in ("dense", "grid", "sweep"):
                col = Collision(dt=0.02, collision_particle_radius=0.03,
                                broad_phase=bp, max_contacting_pairs=20000)
                if bp == "grid":
                    col.configure_grid(x0, obj_ids=ids)
                for dev in ("cpu", "cuda"):
                    args = [torch.from_numpy(a).to(dev) for a in (dx, x0, ids)]
                    c, d = col.detect_collisions(*args, return_diag=True)
                    sets[bp, dev] = pair_set(c)
                    diags[bp, dev] = {k: int(v) for k, v in d.items()}
            n = len(sets["dense", "cpu"])
            same = {bp: sets[bp, "cuda"] == sets[bp, "cpu"]
                    and diags[bp, "cuda"] == diags[bp, "cpu"]
                    for bp in ("dense", "grid", "sweep")}
            exact = all(sets[bp, dev] == sets["dense", dev]
                        for bp in ("grid", "sweep") for dev in ("cpu", "cuda"))
            self.check(all(same.values()) and exact and n > 0
                       and diags["dense", "cuda"]["contacts_overflow"] == 0,
                       f"contact pair sets, seed {seed}, {len(x0)} points: "
                       f"{n} pairs; card = CPU (sets and diagnostics) "
                       f"{same}; grid and sweep = dense on both devices "
                       f"{exact}; the most points in a cell "
                       f"{diags['grid', 'cuda']['max_cell_occupancy']}")
        self.check_stack_step()
        self.check_demo_steps()

    def step_system(self, scene, fn, consts, z_in):
        """The Newton system a step of ``scene`` starts from at state
        ``z_in``: its energy, gradient and Hessian at z, read by stepping
        with ``newtons_method`` replaced by a probe that records them."""
        sim = sys.modules[type(scene).__module__]
        real, got = sim.newtons_method, {}

        def probe(x, energy_fcn, gradient_fcn, hessian_fcn, **kw):
            got.update(energy=energy_fcn(x), gradient=gradient_fcn(x),
                       hessian=hessian_fcn(x))
            return x

        sim.newtons_method = probe
        try:
            with self.torch.no_grad():
                fn(consts, *z_in)
        finally:
            sim.newtons_method = real
        return got

    def check_stack_step(self):
        """The example's stack (2 x 300 points, a 10 x 10 plate) on the card
        against the CPU at 5 of the CPU's states: the card's detection from
        the CPU's displacement equals the CPU's (pairs in order), and the
        contact terms on those contacts at the step the CPU took (energy,
        gradient, Hessian, the pullbacks, the bounds) and the energy of the
        step's Newton system lie within 1e-4 of each one's largest entry.

        The rest of the step is printed, not held: this scene's QR rotation
        has entries up to 7.2e4 (sin(x·f) over a cube of side 0.5 leaves B's
        columns nearly dependent), so ``qr.T @ c_H @ qr`` turns contact
        Hessian entries of 1e8 into a Newton Hessian of some 6e3 whose
        value float32 rounding decides (the JAX package has the same
        rotations); and a 1e-7 change of z moves the next B z by a large
        share of max|B z|. The card's step is checked finite."""
        torch, ex, n = self.torch, self.col_ex, COLLISION_PARITY_STEPS
        f64 = torch.float64
        cpu = ex.stack_scene("cpu", **COLLISION_STACK)
        states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
        for _ in range(n):
            cpu.run_sim_step()
            states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
        card = ex.stack_scene("cuda", **COLLISION_STACK)
        _, same = self.qr_conv(card, cpu)
        fn, consts = card.build_functional_step(with_diag=True)
        fn_c, consts_c = cpu.build_functional_step(with_diag=True)
        col_k, col_c = consts["collision"], consts_c["collision"]
        term_errs, energy_errs, sys_errs, errs, flags, pairs = \
            [], [], [], [], [], []
        same_contacts, finite = True, True

        def rel(a, b):
            return float((a.cpu().double() - b.cpu().double()).abs().max()
                         / max(float(b.abs().max()), 1e-30))

        for k in range(n):
            z_in = [x.cuda() for x in states[k]]
            dx = (cpu.sim_B @ states[k][0]).reshape(-1, 3)
            c_c = col_c.detect_collisions(dx, cpu.sim_pts,
                                          cpu.qp_to_object_map,
                                          cpu.qp_is_kinematic,
                                          weights=consts_c["col_w"])
            c_k = col_k.detect_collisions(dx.cuda(), card.sim_pts,
                                          card.qp_to_object_map,
                                          card.qp_is_kinematic,
                                          weights=consts["col_w"])
            same_contacts &= all(torch.equal(getattr(c_k, f).cpu(),
                                             getattr(c_c, f))
                                 for f in ("indices_a", "indices_b", "valid"))
            pairs.append(int(c_c.valid.sum()))
            zq = consts_c["qr_tfm"] @ (states[k + 1][0] - states[k][0])
            terms = []
            for col, c, dev in ((col_c, c_c, "cpu"), (col_k, c_k, "cuda")):
                z_, d_ = zq.to(dev), 2.0 * zq.to(dev)
                g = col.gradient(c, coeff=1000.0, zq=z_)
                h = col.hessian(c, coeff=1000.0, zq=z_)
                terms.append([col.energy(c, coeff=1000.0, zq=z_), g, h,
                              col.pullback_gradient(c, g),
                              col.reduced_hessian(c, h),
                              col.get_bounds_q(c, d_, z_)])
            term_errs.append(max(rel(a, b) for b, a in zip(*terms)))
            want_sys = self.step_system(cpu, fn_c, consts_c, states[k])
            got_sys = self.step_system(card, fn, consts, z_in)
            energy_errs.append(rel(got_sys["energy"], want_sys["energy"]))
            sys_errs.append(max(rel(got_sys[key], want_sys[key])
                                for key in ("gradient", "hessian")))
            with torch.no_grad():
                out = fn(consts, *z_in)
            finite &= bool(torch.isfinite(out[0]).all())
            want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
            got = card.sim_B.cpu().to(f64) @ out[0].cpu().to(f64)
            errs.append(float((got - want).abs().max()
                              / want.abs().max()))
            flags.append(int(out[3]))
        rot = max(float(o.qr_tfm.abs().max())
                  for o in card.sim_obj_dict.values() if o.qr_tfm is not None)
        self.check(same and same_contacts and max(term_errs) <= SIM_Z_TOL
                   and max(energy_errs) <= SIM_Z_TOL and finite
                   and flags == [0] * n and min(pairs) > 0,
                   f"contact terms card vs CPU [stack {COLLISION_STACK}, "
                   f"{card.total_qp} points, D {card.total_dofs}, "
                   f"{col_k.broad_phase}], {n} states of the CPU: the same "
                   f"QR pivots {same}; contacts the same {same_contacts} "
                   f"({pairs} pairs); contact terms max err / max "
                   + ", ".join(f"{e:.1e}" for e in term_errs)
                   + "; the step's energy " + ", ".join(
                       f"{e:.1e}" for e in energy_errs)
                   + f"; not held (a QR rotation entry of {rot:.4g}): its "
                   "gradient and Hessian " + ", ".join(
                       f"{e:.1e}" for e in sys_errs)
                   + ", its max |d(B z)| / max|B z| "
                   + ", ".join(f"{e:.1e}" for e in errs)
                   + f"; the step finite {finite}, flags {flags} "
                   f"[{self.card}]")

    def check_demo_steps(self):
        """``make_demo_scene``'s scene (48 points, 3 handles, a 25-point
        plate; its QR rotation is small) on the card against the CPU for
        each broad phase: the card's step from each of the CPU's states, by
        B z within 1e-4 of max|B z| plus twice the card's own spread under
        a ±1e-7 change of z (about 1e-7 of max|B z| where the step is well
        conditioned; the CPU tests see 9.1e-5 at step 9, where contacts
        press into the barrier)."""
        torch, ex = self.torch, self.col_ex
        f64 = torch.float64
        for bp, n in COLLISION_DEMO_STEPS.items():
            cpu = ex.demo_scene("cpu", 3, broad_phase=bp, **COLLISION_DEMO)
            states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
            for _ in range(n):
                cpu.run_sim_step()
                states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
            card = ex.demo_scene("cuda", 3, broad_phase=bp, **COLLISION_DEMO)
            conv, same = self.qr_conv(card, cpu)
            fn, consts = card.build_functional_step(with_diag=True)
            bk = card.sim_B.cpu().to(f64)
            u = torch.from_numpy(np.random.RandomState(0).choice(
                [-1.0, 1.0], card.total_dofs).astype(np.float32)).cuda()
            errs, spreads, flags = [], [], []
            for k in range(n):
                z_in = [(x if same else (conv @ x.to(f64)).float()).cuda()
                        for x in states[k]]
                size = max(float(x.abs().max()) for x in
                           (states[k][0], states[k + 1][0]))
                with torch.no_grad():
                    out = fn(consts, *z_in)
                    got = bk @ out[0].cpu().to(f64)
                    spread = max(float((bk @ fn(
                        consts, z_in[0] + e * size * u, *z_in[1:])[0]
                        .cpu().to(f64) - got).abs().max())
                        for e in (1e-7, -1e-7))
                want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
                scale = float(want.abs().max())
                errs.append(float((got - want).abs().max()) / scale)
                spreads.append(spread / scale)
                flags.append(int(out[3]))
            pairs = int(cpu.collision_diagnostics()["num_pairs"])
            rot = float(card.get_object(0).qr_tfm.abs().max())
            self.check(all(e <= SIM_Z_TOL + 2 * s
                           for e, s in zip(errs, spreads))
                       and flags == [0] * n and pairs > 0
                       and all(bool(torch.isfinite(x).all())
                               for x in states[-1]),
                       f"contact step card vs CPU [demo scene, {bp}, "
                       f"{card.total_qp} points, D {card.total_dofs}], {n} "
                       f"steps from the CPU's states: max |d(B z)| / "
                       f"max|B z| " + ", ".join(f"{e:.1e}" for e in errs)
                       + " (the card's own spread under a 1e-7 change of z "
                       + ", ".join(f"{e:.1e}" for e in spreads)
                       + f"); flags {flags}; {pairs} pairs at the end; the "
                       f"same QR pivots {same}, the QR rotation's largest "
                       f"entry {rot:.4g} [{self.card}]")

    def collision_scene(self, graphs=False):
        return self.col_ex.collision_10k_scene("cuda",
                                               use_cuda_graphs=graphs)

    def col_heights(self, scene):
        """Each cube's mean height (the plate, the last object, left out)."""
        return [self.col_ex.mean_height(scene, i)
                for i in range(len(scene.sim_obj_dict) - 1)]

    def phase_collision_path(self):
        """``collision_10k`` at full size: steps and capacity checks until a
        20-step window needs no resize (at most three attempts, as bench.py
        runs it), then 20 eager steps and 20 from the CUDA graph from one
        start, every launch counter set to 0 before each and read after."""
        torch = self.torch
        self.check_precision("phase_collision_path")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scene = self.collision_scene()
        col = scene.force_dict["collision"]["object"]
        build_s = time.perf_counter() - t0
        print(f"collision_10k: {scene.total_qp} contact particles, "
              f"{len(scene.sim_obj_dict)} objects, D {scene.total_dofs} "
              f"({len(scene.dyn_idx)} dynamic), broad phase "
              f"{col.broad_phase}, grid dims {col.grid_dims}, K "
              f"{col.cell_capacity}, M {col.max_occupied_cells}, pp "
              f"{col.point_contact_capacity}, {col.max_contacts} contacts; "
              f"B {tuple(scene.sim_B.shape)}, dF/dz "
              f"{tuple(scene.sim_dFdz.shape)}; the QR rotations' largest "
              f"entries " + ", ".join(
                  f"{float(o.qr_tfm.abs().max()):.4g}"
                  for o in scene.sim_obj_dict.values()
                  if o.qr_tfm is not None)
              + f"; built in {build_s:.1f} s host", flush=True)
        t0 = time.perf_counter()
        for attempt in range(3):
            scene.run_sim_step()
            scene.check_collision_capacity()
            before = scene.collision_resizes
            scene.run_sim_steps(COLLISION_STEPS)
            if scene.collision_resizes == before:
                break
        torch.cuda.synchronize()
        print(f"collision_10k resize loop: {attempt + 1} attempts, "
              f"{scene.current_sim_step} steps, {scene.collision_resizes} "
              f"resizes, K {col.cell_capacity}, M {col.max_occupied_cells}, "
              f"pp {col.point_contact_capacity}, {col.max_contacts} "
              f"contacts; {time.perf_counter() - t0:.1f} s host", flush=True)
        settled = scene.collision_resizes == before
        start = [x.clone() for x in (scene.sim_z, scene.sim_z_prev,
                                     scene.sim_z_dot)]
        runs = {}
        for label, graphs in (("eager", False), ("graph", True)):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs

            def path():
                for _ in range(COLLISION_STEPS):
                    scene.run_sim_step()
                return scene.check_collision_capacity()

            t0 = time.perf_counter()
            flags, launches = self.drive(tuple(KERNELS), path)
            wall = time.perf_counter() - t0
            diag = scene.collision_diagnostics()
            runs[label] = dict(z=scene.sim_z.clone(), flags=flags,
                               pairs=int(diag["num_pairs"]),
                               heights=self.col_heights(scene),
                               launches=launches, wall=wall,
                               finite=all(bool(torch.isfinite(x).all())
                                          for x in (scene.sim_z,
                                                    scene.sim_z_dot)))
            r = runs[label]
            print(f"collision_10k, {COLLISION_STEPS} steps {label}: "
                  f"{wall:.3f} s host wall (the graph's capture included), "
                  f"flags {flags}, {r['pairs']} pairs at the end, cube mean "
                  f"heights " + ", ".join(f"{h:.4f}" for h in r["heights"])
                  + f", {scene.graph_steps_rerun} graph steps run again "
                  f"eagerly, {scene.graph_steps_lu} graph steps took the LU,"
                  f" kernel launches {launches} [{self.card}]", flush=True)
        print(f"collision_10k peak device memory allocated while the path "
              f"ran: {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"(the scene, its steps and its graph, and what earlier "
              f"phases still held) [{self.card}]", flush=True)
        B = scene.sim_B.to(torch.float64)
        be, bg = (B @ runs[k]["z"].to(torch.float64) for k in ("eager",
                                                               "graph"))
        err = float((be - bg).abs().max() / be.abs().max())
        low = min(min(r["heights"]) for r in runs.values())
        self.check(settled and all(r["finite"] and r["flags"] == 0
                                   and r["pairs"] > 0
                                   and not any(r["launches"].values())
                                   for r in runs.values())
                   and low > -0.6 and scene.graph_steps_rerun == 0
                   and err <= SIM_Z_TOL and col.broad_phase == "grid"
                   and scene.total_qp == 10712,
                   f"collision_10k path: a window without resize {settled} "
                   f"({scene.collision_resizes} resizes); eager and graph "
                   f"finite, flags 0, pairs "
                   f"{[r['pairs'] for r in runs.values()]}, no kernel "
                   f"launched; lowest cube mean height {low:.4f} above the "
                   f"floor at -0.6; {scene.graph_steps_rerun} graph steps "
                   f"run again eagerly; graph vs eager max |d(B z)| / "
                   f"max|B z| {err:.3e}")
        self.col.update(scene=scene, start=start, pairs=runs["eager"]["pairs"])
        self.check_resize_under_graph()

    def check_resize_under_graph(self):
        """A capacity resize under the CUDA graph: ``collision_10k``'s
        builder at 2 cubes of 1,100 points (2,216 particles, the grid) with
        64 contacts and a fan-out of 4 a point, eager and from the graph
        side by side, 3 steps a ``run_sim_steps`` call until the flags stay
        0: each overflow frees the graph, re-measures and doubles, and the
        next call captures anew; the two scenes resize alike and end
        together."""
        torch = self.torch
        scenes = [self.col_ex.collision_10k_scene("cuda", 2, 1100, 3, 16,
                                                  use_cuda_graphs=graphs)
                  for graphs in (False, True)]
        for scene in scenes:
            col = scene.force_dict["collision"]["object"]
            col.max_contacts, col.point_contact_capacity = 64, 4
        graph, seen = scenes[1], []
        for _ in range(6):
            for scene in scenes:
                scene.run_sim_steps(3)
            seen.append(scenes[0].collision_resizes)
            if graph._graph is not None:     # this call needed no resize
                break
        col = graph.force_dict["collision"]["object"]
        err = float((scenes[0].sim_B @ (scenes[0].sim_z - graph.sim_z)).abs()
                    .max() / (scenes[0].sim_B @ scenes[0].sim_z).abs().max())
        flags = [int(s._flags()) for s in scenes]
        self.check(graph.collision_resizes == scenes[0].collision_resizes >= 1
                   and flags == [0, 0] and err <= SIM_Z_TOL
                   and graph.graph_steps_rerun == 0
                   and bool(torch.isfinite(graph.sim_z).all()),
                   f"resize under the graph ({graph.total_qp} particles, "
                   f"{col.broad_phase}): resizes after each call {seen} "
                   f"(graph {graph.collision_resizes}), the graph captured "
                   f"{len(seen)} times, capacities now "
                   f"{col.max_contacts} contacts, fan-out "
                   f"{col.point_contact_capacity}, K {col.cell_capacity}, M "
                   f"{col.max_occupied_cells}; flags {flags}; graph vs eager "
                   f"max |d(B z)| / max|B z| {err:.3e}")

    def phase_collision_timing(self):
        """Steps/s of collision_10k from the path's start: eager
        ``run_sim_step``, one graph replay a step and ``run_sim_steps(20)``
        from the graph, CUDA-event medians."""
        torch = self.torch
        self.check_precision("phase_collision_timing")
        scene, start = self.col["scene"], self.col["start"]
        n = COLLISION_TIMED_STEPS

        def reset(graphs):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs

        reset(False)
        before = self.newton.iterations
        e_ms = statistics.median(self.time_ms(scene.run_sim_step, n))
        iters = (self.newton.iterations - before) / (n + 1)
        reset(True)
        rerun = scene.graph_steps_rerun
        g_ms = statistics.median(self.time_ms(scene.run_sim_step, n))
        reset(True)
        r_ms = statistics.median(self.time_ms(
            lambda: scene.run_sim_steps(COLLISION_STEPS), 3))
        rerun = scene.graph_steps_rerun - rerun
        flags = scene.check_collision_capacity()
        self.check(rerun == 0 and flags == 0,
                   f"collision_10k timed steps: {rerun} graph steps run "
                   f"again eagerly, flags {flags}")
        self.col.update(eager_ms=e_ms, graph_ms=g_ms, iterations=iters)
        print(f"collision_10k step, medians from the path's start: eager "
              f"run_sim_step {e_ms:.4f} ms ({1e3 / e_ms:.2f} steps/s, "
              f"{iters:.2f} Newton iterations a step); graph replay "
              f"{g_ms:.4f} ms ({1e3 / g_ms:.2f} steps/s, "
              f"{scene.max_newton_steps} iterations); run_sim_steps"
              f"({COLLISION_STEPS}) from the graph {r_ms:.4f} ms "
              f"({COLLISION_STEPS * 1e3 / r_ms:.2f} steps/s) [{self.card}]",
              flush=True)

    def phase_probe_path(self):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                results, launches = self.drive(GATHER_KERNELS,
                                               lambda: self.pb.main([]))
        finally:
            print(buf.getvalue(), end="")
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        names = tuple(next(iter(x)) for x in lines[1:-1])
        self.check(names == PROBE_NAMES and lines[-1] == {"ALL": results},
                   f"primitives_bench printed every probe line ({len(names)}"
                   f" of {len(PROBE_NAMES)}) and the ALL line")
        print(f"probe path launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"probe path launched {k} ({n} times)")
        for name, n_tab in GATHER_TABLES.items():
            line = results.get(f"table_gather_n{1 << 20}_tab{n_tab}", {})
            route = name.removeprefix("table_gather_")
            self.check(line.get("correct") is True
                       and line.get("route") == route,
                       f"probe table_gather, 2^{n_tab.bit_length() - 1} "
                       f"table: route {line.get('route')}, correct "
                       f"{line.get('correct')}")

    def phase_gather_timing(self):
        print(f"timing on {self.card}", flush=True)
        for name, n_tab in GATHER_TABLES.items():
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            fn = self.counters()[name]
            k_ms, p_ms = self.compare_times(
                lambda: fn(table, idx),
                lambda: self.cg.table_gather_plain(table, idx), 50, 20)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name}, {n_tab} floats, {GATHER_IDX} indices: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)

    # -- the profile ---------------------------------------------------------
    def device_events(self, label, fn, reps, attempts=3):
        """``fn`` run once, then ``reps`` times under ``torch.profiler``
        → [(kernel or copy name, device µs)] of the profiled runs. The
        profiler now and then hands back a trace without device time; such
        a trace is taken again, up to ``attempts`` times."""
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA
        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            with self.profiling.trace(label, TRACE_DIR) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = [(e.name, e.time_range.elapsed_us())
                      for e in prof.events() if e.device_type == cuda]
            if any(us > 0 for _, us in events):
                return events
            print(f"{label}: the profiler recorded no device time; "
                  "tracing again", flush=True)
        raise RuntimeError(f"{label}: no device time in {attempts} traces")

    def wall_ms(self, fn, reps):
        """Host wall ms per call of ``fn`` over ``reps`` calls, synced,
        without the profiler."""
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_ms(self, label, fn, reps=20):
        """Device ms per call of ``fn``, warm: every kernel and copy it
        launches."""
        return sum(us for _, us in self.device_events(label, fn, reps)) \
            / reps / 1e3

    def profile_path(self, label, names, fn, n=PROFILE_STEPS):
        events = self.device_events(label, fn, n)
        busy = sum(us for _, us in events) / n / 1e3
        wall = self.wall_ms(fn, n)
        print(f"{label}: {len(events) / n:.1f} device ops per step, device "
              f"busy {busy:.4f} ms of {wall:.4f} ms host wall per step "
              f"(idle share {1 - busy / wall:.3f}) [{self.card}]")
        for k in names:
            main, *helpers = DEVICE_NAMES[k]
            mine = [us for name, us in events if main in name]
            extra = [us for name, us in events
                     if any(h in name for h in helpers)]
            self.results[k]["device_ms"] = (sum(mine) + sum(extra)) / n / 1e3
            self.per_step[k] = len(mine) / n
            self.check(len(mine) > 0, f"{label} profile holds {k}")
            print(f"  {k}: {self.results[k]['device_ms']:.4f} device ms "
                  f"({sum(extra) / n / 1e3:.4f} of it in "
                  f"{len(extra) / n:g} helper launches), "
                  f"{len(mine) / n:g} launches per step, "
                  f"{100 * self.results[k]['device_ms'] / busy:.1f}% of busy")
        top = {}
        for name, us in events:
            top[name] = top.get(name, 0.0) + us / n / 1e3
        for name, ms in sorted(top.items(), key=lambda x: -x[1])[:8]:
            print(f"    {ms:.4f} ms  {name[:160]}")
        return busy

    def phase_profile(self):
        torch = self.torch
        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        self.profile_path("config-2 step", DIBR_KERNELS,
                          lambda: self.ex.config2_grad(inputs, fvi, feats,
                                                       RES))
        rspc, cam, (tile_px, s_max, c_cap) = self.config3()
        self.profile_path("config-3 frame", SPC_KERNELS,
                          lambda: self.sr.raster_first_hit(
                              rspc, cam, tile_px=tile_px, s_max=s_max,
                              c_cap=c_cap))
        self.check_precision("phase_profile")
        eager = self.sim_scene("config1", "cuda")
        self.sim["eager_busy"] = self.profile_path(
            "config-1 sim step, eager", (), eager.run_sim_step)
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        try:
            busy = self.profile_path(
                "config-1 sim step, graph replay", (), graph.run_sim_step)
        except RuntimeError as err:    # the profiler may not see graphs
            print(f"graph replay profile: {err}; device time not measured")
        else:
            self.check(graph.graph_steps_rerun == 0,
                       f"profiled graph steps: {graph.graph_steps_rerun} "
                       f"run again eagerly")
            if graph.graph_steps_rerun == 0:
                self.sim["graph_busy"] = busy
        self.profile_collision()
        for k in (*DIBR_KERNELS, "spc_raster"):
            self.results[k]["library_ms"] = None
        b = self.spc_bins(rspc, cam, (tile_px, s_max, c_cap))
        dt, it = self.spc_tiles(True, rspc, b)
        self.results["spc_untile"]["library_ms"] = self.device_ms(
            "untile library",
            lambda: self.sr.untile_plain(dt, it, **b["size"]))
        for name, n_tab in GATHER_TABLES.items():
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            fn = self.counters()[name]
            r = self.results[name]
            r["device_ms"] = self.device_ms(name, lambda: fn(table, idx))
            r["library_ms"] = self.device_ms(f"{name} library",
                                             lambda: table[idx])
            self.per_step[name] = 1
            print(f"{name}, {n_tab} floats, {GATHER_IDX} indices, warm: "
                  f"kernel {r['device_ms']:.4f} device ms, table[idx] "
                  f"{r['library_ms']:.4f} device ms [{self.card}]")
        # both routes on every table the shared-memory route can hold: where
        # they cross is where the route rule belongs
        for n_tab in GATHER_SWEEP:
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            ms = {name: self.device_ms(f"sweep {name} {n_tab}",
                                       lambda fn=self.counters()[name]:
                                       fn(table, idx))
                  for name in GATHER_KERNELS}
            print(f"route sweep, {n_tab} floats, {GATHER_IDX} indices, warm:"
                  f" shared memory {ms['table_gather_smem']:.4f}, L2 "
                  f"{ms['table_gather_l2']:.4f} device ms [{self.card}]")
        torch.cuda.synchronize()

    def profile_collision(self):
        """collision_10k from the path's start: an eager step and a graph
        replay (device busy, idle share, the largest ops), and detection
        alone at that state, its share of each."""
        torch = self.torch
        if "scene" not in self.col:
            raise RuntimeError("phase_collision_path did not run")
        scene, start = self.col["scene"], self.col["start"]
        busy = {}
        for label, graphs in (("eager", False), ("graph replay", True)):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs
            rerun = scene.graph_steps_rerun
            busy[label] = self.profile_path(f"collision_10k step, {label}",
                                            (), scene.run_sim_step,
                                            n=COLLISION_PROFILE_STEPS)
            self.check(scene.graph_steps_rerun == rerun,
                       f"profiled collision_10k {label} steps: "
                       f"{scene.graph_steps_rerun - rerun} run again eagerly")
        scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
            x.clone() for x in start)
        col = scene.force_dict["collision"]["object"]
        w = scene.build_functional_step()[1]["col_w"]
        with torch.no_grad():
            dx = (scene.sim_B @ scene.sim_z).reshape(-1, 3)
        det = self.device_ms("collision_10k detection", lambda: (
            col.detect_collisions(dx, scene.sim_pts, scene.qp_to_object_map,
                                  scene.qp_is_kinematic, weights=w,
                                  return_diag=True)))
        self.col.update(eager_busy=busy["eager"],
                        graph_busy=busy["graph replay"], detection_ms=det)
        print(f"collision_10k detection alone (grid, from the start state): "
              f"{det:.4f} device ms, {det / busy['eager']:.3f} of an eager "
              f"step's busy time, {det / busy['graph replay']:.3f} of a "
              f"replay's [{self.card}]", flush=True)

    # -- bounds ------------------------------------------------------------
    def set_bound(self, name, nbytes, ops, what):
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / FP32_OPS_S * 1e3
        r = self.results[name]
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name}: {what}; {nbytes} bytes ({t_bytes:.6f} ms), {ops} "
              f"float32 operations ({t_ops:.6f} ms) -> bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}")

    def box_pairs(self, d, h, w, margin, closed, where=None):
        """(pixel, face) pairs with the pixel centre in the face's box,
        enlarged by ``margin``: closed as the winner search's, half open as
        the soft mask's; only at pixels where ``where`` (H, W) holds, when
        given → pairs per face, (F,)."""
        torch = self.torch
        px, py = self.rast._pixel_coords(h, w, 1000, torch.float32,
                                         d["fvi"].device)
        xs, ys = px[0], py[:, 0]
        v = d["fvi"][0]
        lo, hi = v.amin(dim=1) - margin, v.amax(dim=1) + margin

        def inside(c, k):
            upper = c[None] <= hi[:, k:k + 1] if closed else \
                c[None] < hi[:, k:k + 1]
            return ((c[None] >= lo[:, k:k + 1]) & upper).float()

        cols, rows = inside(xs, 0), inside(ys, 1)           # (F, W), (F, H)
        if where is None:
            return (rows.sum(dim=1) * cols.sum(dim=1)).long()
        # exact in float32: every partial count is below 2^24
        return ((rows @ where.float()) * cols).sum(dim=1).long()

    def sim_bound(self):
        """The config-1 sim step's bound: its float32 operations over 67
        TFLOP/s (the step's bytes, B, dF/dz and BMB read once, take far
        less). Counted per Newton iteration from the scene's sizes, the
        dense products and factorizations only (the elementwise material
        terms add under 1%): the gradient's four products with B and dF/dz
        and BMB·δ; the Hessian's dx and F, its batched (3x3 and 9x9) block
        products and its two (D, ·) x (·, D) reductions; Cholesky (D³/3)
        and LU (2D³/3) with their solves; the line search's QR turns and
        its K = 2m + 2 energies (a product with B and dF/dz each, and the
        kinetic term)."""
        r = self.sim
        if "dofs" not in r:
            raise RuntimeError("phase_sim_timing did not run")
        d, n, m = r["dofs"], r["points"], r["ls"]
        k = 2 * m + 2
        grad = 4 * 2 * 12 * n * d + 2 * d * d
        hess = 2 * 2 * 12 * n * d + 2 * n * d * (9 + 81) \
            + 2 * d * d * 12 * n + 3 * d * d
        solve = d ** 3 / 3 + 2 * d ** 3 / 3 + 4 * 2 * d * d
        search = 2 * d * d + 2 * (k - 1) * d * d + k * (2 * 12 * n * d
                                                       + 2 * d * d)
        per_iter = grad + hess + solve + search
        nbytes = 4 * (12 * n * d + d * d)
        for label, iters, ms in (
                ("graph (fixed trip)", r["newton"], r.get("graph_busy")),
                ("eager (stops early)", r["iterations"], r.get("eager_busy"))):
            ops = per_iter * iters
            t_ops = ops / FP32_OPS_S * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            busy = "not measured" if ms is None else \
                f"{ms:.4f} ms, share {bound / ms:.4f}"
            print(f"config-1 sim step, {label}: {iters:g} Newton iterations"
                  f" x {per_iter / 1e9:.4f} GFLOP ({grad / 1e6:.1f} M "
                  f"gradient, {hess / 1e6:.1f} M Hessian, {solve / 1e6:.1f} M"
                  f" solves, {search / 1e6:.1f} M line search) = "
                  f"{ops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms; {nbytes} bytes "
                  f"-> {t_bytes:.6f} ms; bound {bound:.6f} ms by "
                  f"{'operations' if t_ops >= t_bytes else 'bytes'}; device "
                  f"busy {busy} [{self.card}]")

    def grid_tests(self, scene):
        """The pairs the grid's narrow phase needs at the scene's state: in
        each occupied cell its pairs, and its points against those of its 13
        half-stencil neighbours (the capacities' padding not counted)."""
        col = scene.force_dict["collision"]["object"]
        if col.grid_dims is None:
            return scene.total_qp * (scene.total_qp - 1) // 2
        with self.torch.no_grad():
            cur = (scene.sim_pts + (scene.sim_B @ scene.sim_z).reshape(-1, 3)
                   ).cpu().numpy()
        dims = np.asarray(col.grid_dims)
        cell = np.clip(((cur - col.grid_origin) / np.float32(col.grid_cell)
                        ).astype(np.int64), 0, dims - 1)
        counts = {}
        for c in map(tuple, cell):
            counts[c] = counts.get(c, 0) + 1
        tests = 0
        offsets = ((0, 0, 1), (0, 1, -1), (0, 1, 0), (0, 1, 1),
                   (1, -1, -1), (1, -1, 0), (1, -1, 1), (1, 0, -1),
                   (1, 0, 0), (1, 0, 1), (1, 1, -1), (1, 1, 0), (1, 1, 1))
        for (x, y, z), n in counts.items():
            tests += n * (n - 1) // 2
            for ox, oy, oz in offsets:
                tests += n * counts.get((x + ox, y + oy, z + oz), 0)
        return tests

    def collision_bound(self):
        """collision_10k's step bound: the dense products counted as config
        1's are (``sim_bound``), object by object where the operators are
        block-diagonal (the work the step needs, not the zeros the dense
        scene matrices hold), over 67 TFLOP/s; plus the contact terms at
        this run's contact count C: per Newton iteration the offsets of the
        gradient, Hessian, bounds and the line search's K energies (2 sides
        x 2·3·4H·C each), the pullback (2·4H·3·C), the reduced Hessian's
        nine (4H, C) x (C, 4H) products (9·2·(4H)²·C) and ~200 elementwise
        operations a contact; once a step the narrow phase's tests (19
        operations a pair: two squared distances, the compares) and the
        compaction. Bytes: B and dF/dz blocks, BMB and the contact factors
        read once."""
        c = self.col
        if "iterations" not in c or "pairs" not in c:
            raise RuntimeError("the collision_10k phases did not run")
        scene = c["scene"]
        objs = list(scene.sim_obj_dict.values())
        d = scene.total_dofs
        d_dyn = len(scene.dyn_idx)
        nd = sum(o.num_qp * 12 * o.num_handles for o in objs)
        nd2 = sum(o.num_qp * (12 * o.num_handles) ** 2 for o in objs)
        m = scene.max_ls_steps
        k = 2 * m + 2
        grad = 4 * 2 * 12 * nd + 2 * d * d
        hess = 2 * 2 * 12 * nd + 2 * nd * (9 + 81) + 2 * 12 * nd2 \
            + 3 * d * d
        solve = d_dyn ** 3 / 3 + 2 * d_dyn ** 3 / 3 + 4 * 2 * d_dyn ** 2
        search = 2 * d * d + 2 * (k - 1) * d * d + k * (2 * 12 * nd
                                                       + 2 * d * d)
        h4 = d // 3
        cc = c["pairs"]
        offsets = (3 + k) * 2 * 2 * 3 * h4 * cc
        contact = offsets + 2 * h4 * 3 * cc + 9 * 2 * h4 * h4 * cc \
            + (200 + 9 * h4) * cc
        per_iter = grad + hess + solve + search + contact
        tests = self.grid_tests(scene)
        detect = tests * 19 + 16 * scene.total_qp
        nbytes = 4 * (12 * nd + d * d) + 4 * 2 * h4 * cc
        for label, iters, ms in (
                ("graph (fixed trip)", scene.max_newton_steps,
                 c.get("graph_busy")),
                ("eager (stops early)", c["iterations"], c.get("eager_busy"))):
            ops = per_iter * iters + detect
            t_ops = ops / FP32_OPS_S * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            busy = "not measured" if ms is None else \
                f"{ms:.4f} ms, share {bound / ms:.4f}"
            print(f"collision_10k step, {label}: {iters:g} Newton iterations"
                  f" x {per_iter / 1e9:.4f} GFLOP ({grad / 1e6:.1f} M "
                  f"gradient, {hess / 1e6:.1f} M Hessian, {solve / 1e6:.1f} M"
                  f" solves, {search / 1e6:.1f} M line search, "
                  f"{contact / 1e6:.1f} M contact terms at C = {cc}) + "
                  f"{detect / 1e6:.1f} M detection ({tests} pair tests) = "
                  f"{ops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms; {nbytes} bytes "
                  f"-> {t_bytes:.6f} ms; bound {bound:.6f} ms by "
                  f"{'operations' if t_ops >= t_bytes else 'bytes'}; device "
                  f"busy {busy} [{self.card}]")

    def phase_bounds(self):
        torch = self.torch
        d, h, w = self.sphere_case(RES)
        f = d["fvi"].shape[1]
        hw = h * w
        pairs1 = int(self.box_pairs(d, h, w, 0.0, True)[d["valid"][0]].sum())
        pairs2 = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False).sum())
        self.set_bound("winner", f * (12 + 24 + 1) + hw * 4,
                       pairs1 * WINNER_OPS,
                       f"{pairs1} (pixel, face) pairs in closed boxes x "
                       f"{WINNER_OPS}")
        face_ops = f * SOFT_FACE_OPS
        every = max((f * 24 + hw * 4) / HBM_BYTES_S,
                    (face_ops + pairs2 * SOFT_FWD_OPS) / FP32_OPS_S) * 1e3
        # on the main path the forward takes the rasterizer's ids and
        # computes only the pixels they leave uncovered
        ids = self.rast.rasterize_search_plain(d["fvz"], d["fvi"], d["valid"],
                                               1000, 1e-8, h, w)
        pairs2u = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False,
                                     ids[0] < 0).sum())
        self.set_bound("soft_mask_fwd", f * 24 + hw * 4 + hw * 4,
                       face_ops + pairs2u * SOFT_FWD_OPS,
                       f"faces, ids read, allprob written; {f} faces x "
                       f"{SOFT_FACE_OPS} ({face_ops}) + {pairs2u} pairs at "
                       f"uncovered pixels, of {pairs2} in the enlarged boxes, "
                       f"x {SOFT_FWD_OPS} ({pairs2u * SOFT_FWD_OPS}); every "
                       f"pixel computed: {every:.6f} ms")
        for name, margin, valid in (("winner", 0.0, d["valid"]),
                                    ("soft_mask_fwd", 0.02 * 1000.0, None)):
            lists = self.rast.tile_face_lists(d["fvi"], h, w, 1000,
                                              margin=margin,
                                              valid_mask=valid)[0]
            n = [len(x) for x in lists]
            busy = [x for x in n if x]
            print(f"{name}: {len(busy)} of {len(n)} tiles list a face, "
                  f"{statistics.mean(busy):.1f} faces a busy tile on average"
                  f" (most {max(busy)}), {sum(n)} listed in all")
        # the backward's pairs at pixels whose cotangent is zero (those the
        # rasterizer covers) add nothing: it needs only the others
        g, allprob = self.soft_cotangent(d, h, w)
        live = (g * allprob)[0] != 0
        pairs3 = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False,
                                    live).sum())
        self.set_bound("soft_mask_bwd", f * 24 + hw * 4 + f * 24,
                       face_ops + pairs3 * SOFT_BWD_OPS,
                       f"{f} faces x {SOFT_FACE_OPS} ({face_ops}) + {pairs3}"
                       f" pairs with a non-zero cotangent, of {pairs2}, x "
                       f"{SOFT_BWD_OPS} ({pairs3 * SOFT_BWD_OPS})")

        rspc, cam, caps = self.config3()
        b = self.spc_bins(rspc, cam, caps)
        work = {}
        self.sr.raster_tiles_plain(b["tab"], b["counts"], b["dz"], b["cam"],
                                   rspc.l3boxes, rspc.units, rspc.uaabb,
                                   **b["size"], work=work)
        busy_px = int((b["counts"] > 0).sum()) * caps[0] ** 2
        l3 = int((rspc.l3boxes[:, 0] < 1.0e38).sum())
        tests = work["unit_tests"] + work["needed_leaf_tests"] + busy_px * l3
        ins = (b["tab"], b["counts"], b["dz"], b["cam"], rspc.l3boxes,
               rspc.units, rspc.uaabb)
        t_p = b["tab"].shape[1] * caps[0] ** 2
        self.set_bound("spc_raster", sum(x.numel() * 4 for x in ins)
                       + 2 * t_p * 4, tests * SLAB_OPS,
                       f"{tests} slab tests the walk needs "
                       f"({work['unit_tests']}"
                       f" (pixel, unit box), {work['needed_leaf_tests']} "
                       f"(pixel, leaf) of the units a ray enters nearer than "
                       f"its best, {busy_px * l3} (pixel, level-3 box) on "
                       f"{busy_px} pixels of busy tiles and {l3} boxes) x "
                       f"{SLAB_OPS}; every leaf of every unit walked would be "
                       f"{work['slab_tests']}")
        self.set_bound("spc_untile", 4 * t_p * 4, 0,
                       f"{t_p} depths and ids read, as many written")
        for name, n_tab in GATHER_TABLES.items():
            n = GATHER_IDX[0] * GATHER_IDX[1]
            self.set_bound(name, 4 * n_tab + 8 * n, 0,
                           f"a {n_tab}-float table once, {n} indices read "
                           f"and values written")
        torch.cuda.synchronize()
        self.sim_bound()
        self.collision_bound()

        # the order in which to make the kernels faster: first those slower
        # than their library call, largest factor first; then by launches
        # per step x (device ms - bound ms)
        r = self.results
        slower = sorted((k for k in r if r[k]["library_ms"] is not None
                         and r[k]["device_ms"] > r[k]["library_ms"]),
                        key=lambda k: -r[k]["device_ms"] / r[k]["library_ms"])
        rest = sorted((k for k in r if k not in slower),
                      key=lambda k: -self.per_step[k]
                      * (r[k]["device_ms"] - r[k]["bound_ms"]))
        for i, k in enumerate(slower + rest, 1):
            lib = r[k]["library_ms"]
            print(f"order {i}: {k}: device {r[k]['device_ms']:.4f} ms, bound "
                  f"{r[k]['bound_ms']:.6f} ms ({r[k]['bound_by']}), share "
                  f"{r[k]['bound_ms'] / r[k]['device_ms']:.4f}, library "
                  + ("none" if lib is None else f"{lib:.4f} ms")
                  + f", {self.per_step[k]:g} launches per step [{self.card}]")

    def run(self):
        for phase in (self.phase_card, self.phase_build, self.phase_parity,
                      self.phase_spc_parity, self.phase_gather_parity,
                      self.phase_sim_parity, self.phase_collision_parity,
                      self.phase_main_path, self.phase_spc_main_path,
                      self.phase_probe_path, self.phase_sim_path,
                      self.phase_collision_path, self.phase_timing,
                      self.phase_spc_timing, self.phase_gather_timing,
                      self.phase_sim_timing, self.phase_collision_timing,
                      self.phase_profile, self.phase_bounds):
            print(f"== {phase.__name__}", flush=True)
            t0 = time.perf_counter()
            try:
                phase()
            except Exception:   # report the phase, run the others
                traceback.print_exc()
                sys.stdout.flush()
                self.failures.append(phase.__name__)
                if phase in (self.phase_card, self.phase_build):
                    break
            finally:
                print(f"   ({phase.__name__}: {time.perf_counter() - t0:.1f}"
                      f" s)", flush=True)
        for name, r in self.results.items():
            missing = [k for k in ENTRY_KEYS[1:] if k not in r]
            self.check(not missing, f"{name} has every number ({missing} "
                       "missing)")
        return not self.failures


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smoke = Smoke()
    ok = smoke.run()
    if not ok:
        print(f"chip_smoke: FAILED {smoke.failures}", file=sys.stderr)
        return 1
    kernels = [{"name": name, **r} for name, r in smoke.results.items()]
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
