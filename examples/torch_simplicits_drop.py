"""Simplicits drop with the PyTorch port: an elastic cube falls onto a floor.

BASELINE config 1, the scene of ``bench.py``'s ``bench_simplicits``: 1,000
quadrature points uniform in [-0.5, 0.5]³ from ``RandomState(0)``, 33
handles (32 smooth synthetic skinning weights and the constant one, so 396
DOFs), Young's modulus 1e4, Poisson ratio 0.45, density 500; dt 0.01, 5
Newton and 10 line-search steps, a direct solve; gravity (0, 9.8, 0) and a
floor at y = -1 with penalty 10,000; 150 steps. ``graft_scene`` is the
smaller scene of ``__graft_entry__._make_scene`` (256 points, 9 handles,
dt 0.03, 3 Newton and 5 line-search steps).

``main`` runs the 150 steps on the CUDA device by default, on the CPU when
``cpu`` is named, and prints the mean height every 30 steps and the steps
per second of the host's clock:

    PYTHONPATH=. python examples/torch_simplicits_drop.py [cuda|cpu] [graph]

``graph`` replays one captured CUDA graph per step.
"""

import sys
import time

import numpy as np
import torch

from kaolin_tpu_torch.physics.simplicits import (
    SimplicitsScene,
    SkinnedPhysicsPoints,
)

STEPS = 150


def config1_points(num_qp=1000, num_handles=33):
    """``bench.py``'s ``_synthetic_skinned_points`` in numpy float32:
    w = sin(x·freqs + phases) and the constant handle, dwdx by central
    differences of step 1e-3 → dict of pts (N, 3), w (N, H), dwdx
    (N, H, 3)."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (num_qp, 3)).astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    phases = rng.rand(num_handles - 1).astype(np.float32)

    def weight_fn(x):
        return np.sin(x @ freqs + phases)

    w = np.concatenate([weight_fn(pts), np.ones((num_qp, 1), np.float32)],
                       axis=1)
    eps = 1e-3
    dwdx = np.zeros((num_qp, num_handles, 3), dtype=np.float32)
    for a in range(3):
        pp = pts.copy()
        pp[:, a] += eps
        pm = pts.copy()
        pm[:, a] -= eps
        dwdx[:, :-1, a] = (weight_fn(pp) - weight_fn(pm)) / (2 * eps)
    return {"pts": pts, "w": w, "dwdx": dwdx}


def graft_points(num_qp=256, num_handles=9):
    """``__graft_entry__._make_scene``'s points: w = sin(x·freqs) and the
    constant handle, dwdx exact → dict as :func:`config1_points`."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (num_qp, 3)).astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs), np.ones((num_qp, 1), np.float32)],
                       axis=1).astype(np.float32)
    dwdx = np.zeros((num_qp, num_handles, 3), dtype=np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    return {"pts": pts, "w": w, "dwdx": dwdx}


def make_scene(points, device, timestep, max_newton_steps, max_ls_steps,
               **scene_kw):
    """A drop scene of the points of :func:`config1_points` or
    :func:`graft_points`: the object with QR and normalized weights (the
    defaults of ``add_object``), gravity (0, 9.8, 0), a floor at y = -1."""
    baked = SkinnedPhysicsPoints(pts=points["pts"], yms=1e4, prs=0.45,
                                 rhos=500.0, appx_vol=1.0,
                                 skinning_weights=points["w"],
                                 dwdx=points["dwdx"])
    scene = SimplicitsScene(timestep=timestep,
                            max_newton_steps=max_newton_steps,
                            max_ls_steps=max_ls_steps, direct_solve=True,
                            device=device, **scene_kw)
    scene.add_object(baked)
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0, floor_axis=1,
                          floor_penalty=10000.0)
    return scene


def config1_scene(device, **scene_kw):
    """BASELINE config 1 on ``device`` ("cuda" or "cpu")."""
    return make_scene(config1_points(), device, 0.01, 5, 10, **scene_kw)


def graft_scene(device, **scene_kw):
    """The scene of ``__graft_entry__._make_scene`` on ``device``."""
    return make_scene(graft_points(), device, 0.03, 3, 5, **scene_kw)


def mean_height(scene, obj_idx=0):
    """The mean y of the object's simulated points, deformed."""
    return float(scene.get_object_deformed_pts(obj_idx)[:, 1].mean())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "cpu" in argv else "cuda"
    scene = config1_scene(device, use_cuda_graphs="graph" in argv)
    heights = [mean_height(scene)]
    t0 = time.perf_counter()
    for _ in range(STEPS // 30):
        scene.run_sim_steps(30)
        heights.append(mean_height(scene))
    wall = time.perf_counter() - t0
    print(f"config 1 on {device}: {STEPS} steps in {wall:.3f} s "
          f"({STEPS / wall:.1f} steps/s, mean heights read every 30 steps "
          f"included); mean height every 30 steps: "
          + ", ".join(f"{h:.4f}" for h in heights))
    z = scene.sim_z
    print(f"z finite {bool(torch.isfinite(z).all())}, max|z| "
          f"{float(z.abs().max()):.4f}")
    return heights


if __name__ == "__main__":
    main()
