"""Simplicits contact: the frame loop a kaolin_tpu_torch user writes for a
stack of soft cubes on a kinematic plate, over the port's public API only.

``cubes`` cubes of ``samples`` points drawn uniformly in a cube of side
``cube_side`` around their centres, in rings of ``ring_size`` (centre k
of ring j at (R cos 2πk/K, y₀ + j Δy, R sin 2πk/K), K = ``ring_size``),
each with ``handles`` handles:
``handles`` − 1 smooth skinning weights w = sin(x·f + φ) of the points'
positions (f normal, φ uniform in [0, 1), a cube's own from the seed),
their exact gradients, and the constant handle. They are baked as
``SkinnedPhysicsPoints`` and added to a ``SimplicitsScene`` at
``add_object``'s defaults; a plate of ``plate_points`` points on a grid at
``plate_height``, one constant handle, is added kinematic, without the QR.
Gravity, a floor, and contact (``enable_collisions``, the broad phase the
scene picks, the grid's capacities the configuration's) follow. On the card the scene replays its captured CUDA
graphs (``use_cuda_graphs``); on the CPU it steps eagerly. The seed draws
points, frequencies and phases; it never changes a shape.

A frame: ``run_sim_step()``; ``get_object_deformed_pts(i)`` for each cube,
the points a viewer draws; after every ``episode_frames``-th frame (the
traffic's), ``reset_scene()``. A frame's loss is the cubes' mean height,
plus nan where the scene's contact-overflow flags are set (a step that
dropped contacts is a failed frame), a 0-d tensor on the scene's device
that no one reads in the window.

Each part runs inside a ``torch.profiler.record_function`` span of the
benchmark's (``SPANS``).
"""

import math

import torch
from torch.profiler import record_function

from kaolin_tpu_torch.physics.simplicits import (
    SimplicitsScene,
    SkinnedPhysicsPoints,
)
from kaolin_tpu_torch.utils import profiling

SPANS = ("sim_step", "deformed_pts", "reset")
NEWTON_ITERATIONS = "physics.simplicits.newton_iterations"


def centre(cfg, i):
    """Cube i's centre: ``ring_size`` cubes a ring."""
    k = cfg["ring_size"]
    ang = 2 * math.pi * (i % k) / k
    return (cfg["ring_radius"] * math.cos(ang),
            cfg["ring_base"] + cfg["ring_step"] * (i // k),
            cfg["ring_radius"] * math.sin(ang))


def plate_points(cfg, device):
    """The plate's points (P, 3): the first ``plate_points`` of a square
    grid over [−e, e]² at ``plate_height``, x fastest."""
    side = math.ceil(math.sqrt(cfg["plate_points"]))
    ext = cfg["plate_extent"]
    grid = torch.linspace(-ext, ext, side, dtype=torch.float64)
    gz, gx = torch.meshgrid(grid, grid, indexing="ij")
    pts = torch.stack([gx.reshape(-1), torch.full((side * side,),
                                                  cfg["plate_height"],
                                                  dtype=torch.float64),
                       gz.reshape(-1)], 1)[:cfg["plate_points"]]
    return pts.to(device=device, dtype=torch.float32)


def make_inputs(cfg, mix, seed, device):
    """Each cube's points (N, 3), weights (N, H) and their gradients
    (N, H, 3), drawn on ``device`` from ``seed``; the plate's points; the
    traffic's episode length."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, h, side = cfg["samples"], cfg["handles"], cfg["cube_side"]
    cubes = []
    for i in range(cfg["cubes"]):
        c = torch.tensor(centre(cfg, i), device=device)
        pts = c + (torch.rand((n, 3), generator=gen, device=device)
                   - 0.5) * side
        freqs = torch.randn((3, h - 1), generator=gen, device=device)
        phases = torch.rand((h - 1,), generator=gen, device=device)
        arg = pts @ freqs + phases
        weights = torch.cat([torch.sin(arg), torch.ones_like(pts[:, :1])],
                            dim=1)
        dwdx = torch.zeros((n, h, 3), device=device)
        dwdx[:, :-1, :] = torch.cos(arg)[:, :, None] * freqs.T[None]
        cubes.append({"pts": pts, "weights": weights, "dwdx": dwdx})
    return {"cubes": cubes, "plate": plate_points(cfg, device),
            "episode_frames": mix["episode_frames"]}


def build(cfg, inputs, device):
    """The scene of the cubes, the plate, gravity, the floor and contact, in
    float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = SimplicitsScene(
        direct_solve=cfg["direct_solve"], timestep=cfg["timestep"],
        max_newton_steps=cfg["max_newton_steps"],
        max_ls_steps=cfg["max_ls_steps"],
        newton_hessian_regularizer=cfg["newton_hessian_regularizer"],
        conv_tol=cfg["conv_tol"], device=device,
        use_cuda_graphs=(cfg["use_cuda_graphs"]
                         and torch.device(device).type == "cuda"))
    for cube in inputs["cubes"]:
        scene.add_object(SkinnedPhysicsPoints(
            pts=cube["pts"], yms=cfg["youngs_modulus"],
            prs=cfg["poisson_ratio"], rhos=cfg["density"],
            appx_vol=cfg["appx_vol"], skinning_weights=cube["weights"],
            dwdx=cube["dwdx"]))
    plate = inputs["plate"]
    p = plate.shape[0]
    scene.add_object(SkinnedPhysicsPoints(
        pts=plate, yms=cfg["plate_youngs_modulus"], prs=cfg["poisson_ratio"],
        rhos=cfg["plate_density"], appx_vol=cfg["plate_appx_vol"],
        skinning_weights=torch.ones((p, 1), device=plate.device),
        dwdx=torch.zeros((p, 1, 3), device=plate.device)),
        is_kinematic=True, apply_qr=False,
        normalize_weights_by_samples=False)
    scene.set_scene_gravity(tuple(cfg["gravity"]))
    scene.set_scene_floor(floor_height=cfg["floor_height"],
                          floor_axis=cfg["floor_axis"],
                          floor_penalty=cfg["floor_penalty"])
    scene.enable_collisions(
        collision_particle_radius=cfg["collision_particle_radius"],
        detection_ratio=cfg["detection_ratio"],
        impenetrable_barrier_ratio=cfg["impenetrable_barrier_ratio"],
        collision_penalty=cfg["collision_penalty"],
        max_contact_pairs=cfg["max_contact_pairs"],
        friction=cfg["friction"], cell_capacity=cfg["cell_capacity"],
        max_occupied_cells=cfg["max_occupied_cells"])
    return {"scene": scene, "frame": 0, "cubes": len(inputs["cubes"]),
            "cube_rows": 3 * sum(c["pts"].shape[0] for c in inputs["cubes"]),
            "episode_frames": inputs["episode_frames"]}


def step(state):
    """One frame → (the cubes' mean height, nan where contacts overflowed;
    the frame's outputs: the cubes' points and the state it accepted, z
    and ż), without a host read but the scene's own."""
    scene = state["scene"]
    with record_function("sim_step"):
        scene.run_sim_step()
    with record_function("deformed_pts"):
        pts = [scene.get_object_deformed_pts(i)
               for i in range(state["cubes"])]
        height = torch.stack([p[:, 1].mean() for p in pts]).mean()
        height = height + torch.where(
            scene.collision_overflow_flags() != 0, float("nan"), 0.0)
    out = {"pts": pts, "z": scene.sim_z, "z_dot": scene.sim_z_dot}
    state["frame"] += 1
    if state["frame"] % state["episode_frames"] == 0:
        with record_function("reset"):
            scene.reset_scene()
    return height, out


def total_energy(scene, z, z_dot):
    """Kinetic ½ żᵀBᵀMBż plus the scene's point-wise (gravity, floor) and
    deformation-gradient-wise (elastic) energies at z, and the contact
    barrier of the pairs within detection reach at z (no motion since that
    detection, so no friction), by the scene's own operators and force
    objects."""
    with torch.no_grad():
        dx = (scene.sim_B @ z).reshape(-1, 3)
        F = (scene.sim_dFdz @ z).reshape(-1, 3, 3) + torch.eye(
            3, dtype=z.dtype, device=z.device)
        energy = 0.5 * z_dot @ (scene.sim_BMB @ z_dot)
        for f in scene.force_dict["pt_wise"].values():
            energy = energy + f["object"].energy(dx, scene.sim_pts,
                                                 f["coeff"])
        for f in scene.force_dict["defo_grad_wise"].values():
            energy = energy + f["object"].energy(F, f["coeff"])
        col = scene.force_dict["collision"]
        contacts = col["object"].detect_collisions(
            dx, scene.sim_pts, scene.qp_to_object_map, scene.qp_is_kinematic)
        energy = energy + col["object"].energy(contacts, dx=dx,
                                               coeff=col["coeff"])
    return energy


def first_steps(state, n):
    """Run the first ``n`` frames through :func:`step` and keep what the
    check compares: each frame's start (the cubes' displacement B z and
    velocity B ż, in float64, which the reference steps from), its cube
    points and the total energy at the state it accepted."""
    scene = state["scene"]
    rows = state["cube_rows"]
    starts, pts, energy = [], [], []
    for _ in range(n):
        b = scene.sim_B[:rows].double()
        starts.append((b @ scene.sim_z.double(),
                       b @ scene.sim_z_dot.double()))
        _, out = step(state)
        pts.append(torch.cat(out["pts"]))
        energy.append(total_energy(scene, out["z"], out["z_dot"]))
    return {"starts": starts, "pts": pts, "energy": energy}


def geometry(state):
    """What the step's roofline and the pair share count from, read before
    and after the traced window: the Newton iterations the scene's graphs
    ran so far (the port's host counter), the contact buffer's capacity and
    the grid's occupied cells and slots a cell."""
    col = state["scene"].force_dict["collision"]["object"]
    return {"newton_iterations":
            profiling.counters().get(NEWTON_ITERATIONS, 0),
            "contact_capacity": col.max_contacts,
            "occupied_cells": col.max_occupied_cells,
            "cell_capacity": col.cell_capacity,
            "broad_phase": col.broad_phase}
