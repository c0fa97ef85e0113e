"""Simulatable 3D gaussian splats with the PyTorch port (BASELINE config 5).

A shell of gaussians → the volumetric densifier → a Simplicits soft body
with contact and a floor → simulate → move the renderable gaussians
with the body by linear blend skinning every step.

``bench_scene`` is ``bench.py``'s ``bench_gaussians_sim``: 2,000 gaussians
on a sphere of radius 0.4 about (0, 0.6, 0) from ``RandomState(0)``
(scales 0.05, identity rotations, opacity 0.9),
``sample_points_in_volume(octree_level=6, num_samples=2048,
method="floodfill")``, Young's modulus 2e5, Poisson ratio 0.45, density
500, 16 handles (``sin(x @ freqs)`` with freqs (3, 15) from the same
generator, and the constant one), dt 0.03, 5 Newton and 10 line-search
steps, a direct solve, gravity (0, 9.8, 0), a floor at 0 with penalty
1,000 and contact, 100 steps. The auto broad phase takes the dense pair
matrix there, as the JAX package's does: the 2,048 points pack tighter
than the contact radius, so the grid's cells would hold so many points
that it would test more pairs than the N² matrix. ``main`` is
``examples/simulatable_gaussians.py``: 500 gaussians of scale 0.06, 400
samples, 8 handles, 3 Newton steps, 256 quadrature points, 20 steps.

Both run on the CUDA device unless ``cpu`` is named:

    PYTHONPATH=. python examples/torch_simulatable_gaussians.py [cuda|cpu]
        [bench] [graph] [--steps N]

``bench`` runs ``bench_scene``, ``graph`` replays one CUDA graph a step.
"""

import sys
import time

import numpy as np
import torch

from kaolin_tpu_torch.ops.gaussians import sample_points_in_volume
from kaolin_tpu_torch.physics.simplicits import (
    PhysicsPoints,
    SimplicitsObject,
    SimplicitsScene,
)

BENCH = dict(num_gaussians=2000, scale=0.05, num_samples=2048,
             num_handles=16, num_qp=2048, max_newton_steps=5,
             direct_solve=True, steps=100)
EXAMPLE = dict(num_gaussians=500, scale=0.06, num_samples=400, num_handles=8,
               num_qp=256, max_newton_steps=3, direct_solve=True, steps=20)


def shell_gaussians(num_gaussians, scale, seed=0):
    """Gaussians on a sphere of radius 0.4 about (0, 0.6, 0) → (xyz, scales,
    rots (wxyz), opacities) float32 numpy, and the generator, whose next
    draws are the skinning frequencies."""
    rng = np.random.RandomState(seed)
    d = rng.randn(num_gaussians, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xyz = (0.4 * d + np.array([0.0, 0.6, 0.0])).astype(np.float32)
    scales = np.full((num_gaussians, 3), scale, np.float32)
    rots = np.tile(np.array([1.0, 0, 0, 0], np.float32), (num_gaussians, 1))
    opac = np.full((num_gaussians,), 0.9, np.float32)
    return (xyz, scales, rots, opac), rng


def densify(gaussians, num_samples, device, key=None):
    """The shell's interior points: the densifier at level 6 by flood fill,
    on ``device``."""
    return sample_points_in_volume(*gaussians, octree_level=6,
                                   num_samples=num_samples,
                                   method="floodfill", key=key,
                                   device=device)


def make_scene(xyz, vol_pts, freqs, device, num_qp, max_newton_steps,
               direct_solve, collisions=None, **scene_kw):
    """A scene of one soft body sampled at ``vol_pts`` with weights
    ``sin(x @ freqs)`` → (scene, object id): E 2e5, ν 0.45, ρ 500, the
    sphere's volume; dt 0.03, 10 line-search steps; gravity, a floor at 0
    and contact (``enable_collisions(**collisions)``; its defaults choose
    the broad phase). ``xyz`` are the renderable points."""
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=device)
    phys = PhysicsPoints(pts=torch.as_tensor(vol_pts, device=device),
                         yms=2e5, prs=0.45, rhos=500.0,
                         appx_vol=4 / 3 * np.pi * 0.4 ** 3)
    obj = SimplicitsObject.create_from_function(
        phys, lambda x: torch.sin(x @ freqs))
    scene = SimplicitsScene(timestep=0.03, max_newton_steps=max_newton_steps,
                            max_ls_steps=10, direct_solve=direct_solve,
                            device=device, **scene_kw)
    obj_idx = scene.add_object(obj, num_qp=num_qp,
                               renderable_pts=torch.as_tensor(xyz,
                                                              device=device))
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=0.0, floor_penalty=1000.0)
    scene.enable_collisions(**(collisions or {}))
    return scene, obj_idx


def build(cfg, device, vol_pts=None, collisions=None, **scene_kw):
    """The scene of ``cfg`` (:data:`BENCH` or :data:`EXAMPLE`) → (scene,
    object id, renderable xyz, interior points). ``vol_pts`` replaces the
    densifier's points (one scene's points for another)."""
    gaussians, rng = shell_gaussians(cfg["num_gaussians"], cfg["scale"])
    if vol_pts is None:
        vol_pts = densify(gaussians, cfg["num_samples"], device)
    freqs = rng.randn(3, cfg["num_handles"] - 1).astype(np.float32)
    scene, obj_idx = make_scene(gaussians[0], vol_pts, freqs, device,
                                cfg["num_qp"], cfg["max_newton_steps"],
                                cfg["direct_solve"], collisions, **scene_kw)
    return scene, obj_idx, gaussians[0], vol_pts


def bench_scene(device=None, **scene_kw):
    """``bench.py``'s ``bench_gaussians_sim`` scene on ``device`` (None:
    the CUDA device)."""
    return build(BENCH, "cuda" if device is None else device, **scene_kw)


def rollout(scene, obj_idx, num_steps):
    """``num_steps`` sim steps (a graph replay each when the scene was made
    with ``use_cuda_graphs``), the renderable points moved by LBS after
    each → (num_steps, N, 3)."""
    pts = scene.get_object(obj_idx).renderable.pts
    out = torch.empty((num_steps,) + tuple(pts.shape), dtype=pts.dtype,
                      device=pts.device)
    for i in range(num_steps):
        scene.run_sim_step()
        out[i] = scene.get_object_deformed_pts(obj_idx, points="rendered")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "cpu" in argv else "cuda"
    cfg = dict(BENCH if "bench" in argv else EXAMPLE)
    if "--steps" in argv:
        cfg["steps"] = int(argv[argv.index("--steps") + 1])
    t0 = time.perf_counter()
    scene, obj_idx, xyz, vol_pts = build(
        cfg, device, use_cuda_graphs="graph" in argv)
    print(f"densifier: {vol_pts.shape[0]} interior points from "
          f"{xyz.shape[0]} shell gaussians; set-up "
          f"{time.perf_counter() - t0:.3f} s on {device}")
    t0 = time.perf_counter()
    moved = rollout(scene, obj_idx, cfg["steps"])
    heights = moved[:, :, 1].mean(dim=1).cpu().numpy()
    wall = time.perf_counter() - t0
    for step in range(0, cfg["steps"], max(1, cfg["steps"] // 4)):
        print(f"step {step:3d}: gaussian mean height {heights[step]:+.3f}")
    print(f"{cfg['steps']} steps in {wall:.3f} s "
          f"({1e3 * wall / cfg['steps']:.3f} ms/step, host clock), "
          f"collision flags {scene.check_collision_capacity()}, broad phase "
          f"{scene.force_dict['collision']['object'].broad_phase}")
    tfms = scene.get_object_point_transforms(obj_idx, points="rendered")
    print(f"per-gaussian 4x4 transforms for rendering: "
          f"{tuple(tfms.shape)}")
    return heights


if __name__ == "__main__":
    main()
