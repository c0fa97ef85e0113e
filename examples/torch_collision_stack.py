"""Multi-body contact with the PyTorch port: soft cubes pile onto a kinematic
plate.

``collision_10k_scene`` is ``bench.py``'s ``collision_10k`` component:
6 soft cubes of 1,700 points (side 0.5, in two rings of three, centres
(0.33 cos a, 0.1 + 0.45 ring, 0.33 sin a)), 6 handles each (5 smooth
synthetic skinning weights sin(x·f + φ) with central-difference gradients,
and the constant one), Young's modulus 1e4, Poisson ratio 0.45, density
500; a kinematic plate of 512 points at y = -0.55 (Young's modulus 1e5,
density 1,000, one constant handle, no QR); gravity (0, 9.8, 0), a floor at
y = -0.6 with penalty 10,000; dt 0.02, 5 Newton and 10 line-search steps,
a direct solve; contact radius 0.03, detection ratio 1.5, 28,000 contact
pairs. 10,712 contact particles take the grid broad phase.

``stack_scene`` is ``examples/collision_stack.py``'s scene: cubes skinned
by an analytic function through ``SimplicitsObject.create_from_function``
over a 23 x 23 plate, 40,000 contact pairs, 20 line-search steps.
``demo_scene`` is ``kaolin_tpu_torch.parallel.simplicits.make_demo_scene``:
a soft body of a few dozen points falling onto a small kinematic plate;
with ``pad`` both objects are padded by ``pad_skinned_physics_points``
(phantom points, as a heterogeneous scene batch pads them), which contact
leaves out. ``pad_points`` is that padding on keyword arrays.

``main`` runs the stack on the CUDA device by default, on the CPU when
``cpu`` is named, and prints the contact pairs, the first cube's mean
height and the overflow every 10 steps:

    PYTHONPATH=. python examples/torch_collision_stack.py [cuda|cpu] \
        [bench] [graph] [--objects N] [--qp N] [--steps N]

``bench`` runs ``collision_10k_scene`` instead; ``graph`` replays one
captured CUDA graph per step.
"""

import argparse
import sys

import numpy as np
import torch

from kaolin_tpu_torch.parallel.simplicits import (
    make_demo_scene,
    pad_skinned_physics_points,
)
from kaolin_tpu_torch.physics.simplicits import (
    PhysicsPoints,
    SimplicitsObject,
    SimplicitsScene,
    SkinnedPhysicsPoints,
)


def synthetic_skinned_points(rng, pts, num_handles, yms=1e4, rhos=500.0,
                             appx_vol=1.0):
    """``bench.py``'s ``_synthetic_skinned_points`` in numpy float32: draws
    freqs (3, H-1) and phases (H-1,) from ``rng``, w = sin(x·freqs +
    phases) and the constant handle, dwdx by central differences of step
    1e-3."""
    num_qp = pts.shape[0]
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
    return SkinnedPhysicsPoints(pts=pts, yms=yms, prs=0.45, rhos=rhos,
                                appx_vol=appx_vol, skinning_weights=w,
                                dwdx=dwdx)


def ring_center(i):
    """Cube i's centre: rings of three, the second 0.45 above the first."""
    ang = 2 * np.pi * (i % 3) / 3
    return np.array([0.33 * np.cos(ang), 0.1 + 0.45 * (i // 3),
                     0.33 * np.sin(ang)], np.float32)


def add_plate(scene, side, count=None):
    """A kinematic plate of ``side`` x ``side`` points (the first ``count``)
    at y = -0.55 over [-0.8, 0.8]²: one constant handle, no QR."""
    gx, gz = np.meshgrid(np.linspace(-0.8, 0.8, side),
                         np.linspace(-0.8, 0.8, side))
    kpts = np.stack([gx.ravel(), np.full(side * side, -0.55), gz.ravel()],
                    axis=1)[:count].astype(np.float32)
    n = kpts.shape[0]
    kin = SkinnedPhysicsPoints(
        pts=kpts, yms=1e5, prs=0.45, rhos=1000.0, appx_vol=0.2,
        skinning_weights=np.ones((n, 1), np.float32),
        dwdx=np.zeros((n, 1, 3), np.float32))
    scene.add_object(kin, is_kinematic=True, apply_qr=False,
                     normalize_weights_by_samples=False)


def finish(scene, max_contact_pairs):
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-0.6, floor_penalty=10000.0)
    scene.enable_collisions(collision_particle_radius=0.03,
                            max_contact_pairs=max_contact_pairs)
    return scene


def collision_10k_scene(device, num_objects=6, qp_per_object=1700,
                        num_handles=6, kinematic_qp=512, **scene_kw):
    """``bench.py``'s ``collision_10k`` scene on ``device`` ("cuda" or
    "cpu"); the smaller sizes are ``bench.py``'s smoke sizes' kind. At 2,048
    contact particles or more it asserts the grid broad phase."""
    rng = np.random.RandomState(0)
    scene = SimplicitsScene(timestep=0.02, max_newton_steps=5,
                            max_ls_steps=10, direct_solve=True,
                            device=device, **scene_kw)
    for i in range(num_objects):
        pts = (ring_center(i) + rng.uniform(-0.25, 0.25, (qp_per_object, 3))
               ).astype(np.float32)
        scene.add_object(synthetic_skinned_points(rng, pts, num_handles,
                                                  appx_vol=0.125))
    add_plate(scene, int(np.ceil(np.sqrt(kinematic_qp))), kinematic_qp)
    finish(scene, 28000)
    if scene.total_qp >= scene.GRID_BROAD_PHASE_THRESHOLD:
        col = scene.force_dict["collision"]["object"]
        assert col.broad_phase == "grid", \
            "the auto rule must pick the grid at N >= 10k"
    return scene


def stack_scene(device, objects=6, qp=1700, plate_side=23,
                max_contact_pairs=40000, **scene_kw):
    """``examples/collision_stack.py``'s scene on ``device``: ``objects``
    cubes of ``qp`` points skinned by sin(x·f), f (3, 5) from
    ``RandomState(0)``, over a ``plate_side``² plate."""
    rng = np.random.RandomState(0)
    scene = SimplicitsScene(timestep=0.02, max_newton_steps=5,
                            max_ls_steps=20, device=device, **scene_kw)
    for i in range(objects):
        pts = (ring_center(i)
               + rng.uniform(-0.25, 0.25, (qp, 3))).astype(np.float32)
        phys = PhysicsPoints(pts=pts, yms=1e4, prs=0.45, rhos=500.0,
                             appx_vol=0.125)
        freqs = torch.from_numpy(rng.randn(3, 5).astype(np.float32))
        obj = SimplicitsObject.create_from_function(
            phys, lambda x, f=freqs: torch.sin(x @ f))
        scene.add_object(obj, num_qp=qp)
    add_plate(scene, plate_side)
    return finish(scene, max_contact_pairs)


def pad_points(arrays, num_qp, num_handles, phantom_origin=(0.0, 1.0e5, 0.0),
               phantom_spacing=10.0):
    """``kaolin_tpu_torch.parallel.simplicits.pad_skinned_physics_points``
    on the keyword arrays of a ``SkinnedPhysicsPoints`` (numpy) → the
    padded keyword arrays (numpy), ``num_real_qp`` among them."""
    p = pad_skinned_physics_points(SkinnedPhysicsPoints(**arrays), num_qp,
                                   num_handles, phantom_origin,
                                   phantom_spacing)
    out = {k: getattr(p, k).cpu().numpy() for k in (
        "pts", "yms", "prs", "rhos", "skinning_weights", "dwdx")}
    return dict(out, appx_vol=p.appx_vol, num_real_qp=p.num_real_qp)


def demo_scene(device, seed, **kwargs):
    """``kaolin_tpu_torch.parallel.simplicits.make_demo_scene``'s scene on
    ``device``: one soft body above a kinematic plate, gravity, a floor
    and contact; ``pad`` = (points, handles of the soft body, points of
    the plate) pads both objects."""
    return make_demo_scene(seed, device=device, **kwargs)


def mean_height(scene, obj_idx=0):
    """The mean y of an object's simulated points, deformed."""
    return float(scene.get_object_deformed_pts(obj_idx)[:, 1].mean())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("words", nargs="*", choices=("cuda", "cpu", "bench",
                                                 "graph"))
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--qp", type=int, default=1700)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = "cpu" if "cpu" in args.words else "cuda"
    graphs = "graph" in args.words
    if "bench" in args.words:
        scene = collision_10k_scene(device, use_cuda_graphs=graphs)
    else:
        scene = stack_scene(device, args.objects, args.qp,
                            use_cuda_graphs=graphs)
    col = scene.force_dict["collision"]["object"]
    print(f"{scene.total_qp} contact particles on {device}, broad phase: "
          f"{col.broad_phase} (grid dims {col.grid_dims}, "
          f"{col.cell_capacity} points a cell, {col.max_occupied_cells} "
          f"occupied cells, {col.point_contact_capacity} contacts a point, "
          f"{col.max_contacts} contacts)")
    heights = []
    for step in range(args.steps):
        scene.run_sim_step()
        if step % 10 == 0:
            diag = scene.collision_diagnostics()
            heights.append(mean_height(scene))
            print(f"step {step:3d}: {int(diag['num_pairs']):5d} contact "
                  f"pairs, object-0 mean height {heights[-1]:+.3f}, overflow"
                  f"={bool(diag['contacts_overflow'])}, flags "
                  f"{int(scene._flags())}")
    diag = scene.collision_diagnostics()
    if bool(diag["contacts_overflow"]):
        raise RuntimeError("contact capacity overflow: raise "
                           "max_contact_pairs")
    print(f"done: {scene.collision_resizes} capacity resizes, no overflow "
          f"left")
    return heights


if __name__ == "__main__":
    main()
