"""Simplicits from a closed mesh with the PyTorch port: sample the inside,
train a skinning field, drop the object on a floor.

The easy-API path of BASELINE config 1 ("Simplicits easy-API: single
sample_data mesh dropped under gravity"), with the mesh built in code: a
closed torus of major radius 0.35 and minor radius 0.15, 64 x 32 segments
(4,096 faces), its ring in the xz-plane centred at y = 1.

1. ``interior_points``: 100,000 candidates uniform in the torus's box from
   ``--seed``, kept where ``check_sign`` puts them inside (about half).
2. ``trained_object``: ``PhysicsPoints`` of those points (Young's modulus
   1e4, Poisson ratio 0.45, density 500, volume 2π²Rr²) and
   ``SimplicitsObject.create_with_mlp`` at full width: 33 handles, 6
   hidden layers of 64, 1,000 sample points and 10 transforms a step,
   learning rate 1e-3, coefficients 1e-1 (elastic) and 1e6 (orthogonal),
   10,000 Adam steps.
3. ``trained_scene``: the object baked at 1,000 quadrature points (396
   DOFs, config 1's operator shapes) in config 1's scene: dt 0.01, 5 Newton
   and 10 line-search steps, a direct solve, gravity (0, 9.8, 0), a floor
   at y = -1 with penalty 10,000; Newton's convergence tolerance 1e-5, not
   1e-4 (see ``trained_scene``).

``main`` runs it on the CUDA device by default, on the CPU when ``cpu`` is
named, logs the training losses every 1,000 steps, then runs 150 steps and
prints the mean height every 30:

    PYTHONPATH=. python examples/torch_simplicits_train.py [cuda|cpu] \
        [graph] [--steps N] [--seed S]

``graph`` replays one captured CUDA graph per sim step; ``--steps`` sets the
training steps (``cpu --steps 50`` takes about 20 s on a CPU).
"""

import argparse
import logging
import math
import sys
import time

import numpy as np
import torch

from kaolin_tpu_torch.ops.mesh import check_sign
from kaolin_tpu_torch.physics.simplicits import (
    PhysicsPoints,
    SimplicitsObject,
    SimplicitsScene,
)

MAJOR, MINOR = 0.35, 0.15
SEGMENTS = (64, 32)
CANDIDATES = 100_000
NUM_HANDLES = 33
LAYERS = 6
NUM_SAMPLES = 1000
BATCH = 10
TRAIN_STEPS = 10_000
NUM_QPS = 1000
SIM_STEPS = 150
CONV_TOL = 1e-5


def torus_volume(major=MAJOR, minor=MINOR):
    return 2 * math.pi ** 2 * major * minor ** 2


def torus_mesh(segments=SEGMENTS, major=MAJOR, minor=MINOR, centre_y=1.0,
               device="cuda"):
    """A closed torus: ``segments`` = (around the ring, around the tube),
    the ring in the xz-plane at height ``centre_y`` → verts (V, 3) float32,
    faces (2 · V, 3) int64 on ``device``."""
    nu, nv = segments
    u = 2 * np.pi * np.arange(nu) / nu
    v = 2 * np.pi * np.arange(nv) / nv
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(vv)
    verts = np.stack([ring * np.cos(uu), centre_y + minor * np.sin(vv),
                      ring * np.sin(uu)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return (torch.as_tensor(verts.astype(np.float32), device=device),
            torch.as_tensor(faces.astype(np.int64), device=device))


def candidates(verts, num, seed):
    """``num`` points uniform in the box of ``verts`` from
    ``RandomState(seed)`` → (num, 3) float32 on the vertices' device."""
    lo = verts.amin(dim=0).cpu().numpy()
    hi = verts.amax(dim=0).cpu().numpy()
    pts = np.random.RandomState(seed).uniform(lo, hi, (num, 3))
    return torch.as_tensor(pts.astype(np.float32), device=verts.device)


def interior_points(verts, faces, num=CANDIDATES, seed=0):
    """The candidates of :func:`candidates` that ``check_sign`` puts inside
    the mesh → (points (M, 3), the share of candidates kept, the box's
    volume)."""
    cand = candidates(verts, num, seed)
    inside = check_sign(verts[None], faces, cand[None])[0]
    box = float(torch.prod(verts.amax(dim=0) - verts.amin(dim=0)))
    return cand[inside], float(inside.float().mean()), box


def trained_object(pts, train_steps=TRAIN_STEPS, seed=0,
                   num_handles=NUM_HANDLES, layers=LAYERS,
                   num_samples=NUM_SAMPLES, batch=BATCH, log_every=1000):
    """Step 2: a skinning MLP trained on the interior points ``pts`` on
    their device, the generator seeded with ``seed``."""
    phys = PhysicsPoints(pts=pts, yms=1e4, prs=0.45, rhos=500.0,
                         appx_vol=torus_volume())
    return SimplicitsObject.create_with_mlp(
        phys, num_handles=num_handles, num_samples=num_samples,
        model_layers=layers, training_batch_size=batch,
        training_num_steps=train_steps, training_log_every=log_every,
        key=seed)


def trained_scene(obj, num_qps=NUM_QPS, **scene_kw):
    """Step 3: ``obj`` baked at ``num_qps`` points in config 1's scene on
    the object's device, with Newton's convergence tolerance at 1e-5.

    Newton stops, before its first update, once |dx·g| < conv_tol. The
    torus weighs 77.7 kg (config 1's cube 500 kg), and at rest under
    gravity at dt 0.01 its first |dx·g| is about 7.5e-5: with the default
    1e-4 it would never move, in this package as in the JAX one."""
    scene = SimplicitsScene(timestep=0.01, max_newton_steps=5,
                            max_ls_steps=10, direct_solve=True,
                            conv_tol=CONV_TOL, device=obj.pts.device,
                            **scene_kw)
    scene.add_object(obj, num_qp=num_qps)
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0, floor_axis=1,
                          floor_penalty=10000.0)
    return scene


def mean_height(scene, obj_idx=0):
    """The mean y of the object's simulated points, deformed."""
    return float(scene.get_object_deformed_pts(obj_idx)[:, 1].mean())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("words", nargs="*", choices=("cuda", "cpu", "graph"))
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = "cpu" if "cpu" in args.words else "cuda"
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    verts, faces = torus_mesh(device=device)
    pts, share, box = interior_points(verts, faces, seed=args.seed)
    print(f"torus of {faces.shape[0]} faces on {device}: {pts.shape[0]} of "
          f"{CANDIDATES} candidates inside ({share:.4f}; the torus's "
          f"volume share of its box {torus_volume() / box:.4f})")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    obj = trained_object(pts, args.steps, args.seed)
    sync()
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {train_s:.2f} s "
          f"({args.steps / train_s:.1f} steps/s)")
    scene = trained_scene(obj, use_cuda_graphs="graph" in args.words)
    heights = [mean_height(scene)]
    t0 = time.perf_counter()
    for _ in range(SIM_STEPS // 30):
        scene.run_sim_steps(30)
        heights.append(mean_height(scene))
    wall = time.perf_counter() - t0
    print(f"{SIM_STEPS} sim steps (D {scene.total_dofs}) in {wall:.3f} s; "
          f"mean height every 30 steps: "
          + ", ".join(f"{h:.4f}" for h in heights))
    print(f"z finite {bool(torch.isfinite(scene.sim_z).all())}")
    return heights


if __name__ == "__main__":
    main()
