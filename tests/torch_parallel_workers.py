"""The gloo ranks of ``tests/test_torch_parallel.py``.

``run`` is spawned once for that module, in processes that import neither
``jax`` nor ``kaolin_tpu`` (this module imports neither, and each rank
reports what it has loaded). Each rank opens a gloo group from a file in
the test's temporary directory, builds the 1-D ``"dp"`` mesh, runs every
job in order and rank 0 writes the gathered results (numpy) to a pickle.
"""

import pickle
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _full(x):
    return x.full_tensor().detach().numpy()


def job_chamfer(mesh, p1, p2):
    from kaolin_tpu_torch.parallel import sharded_chamfer_distance
    return _full(sharded_chamfer_distance(mesh, torch.from_numpy(p1),
                                          torch.from_numpy(p2)))


def job_dibr(mesh, height, width, fvz, fvi, feats, nz):
    """The three outputs, and the gradient of the soft mask's sum by the
    image-space vertices: each rank's reaches its own views, and the sum
    over the ranks is the whole."""
    from kaolin_tpu_torch.parallel import sharded_dibr_rasterization
    fvi_t = torch.from_numpy(fvi).requires_grad_(True)
    outs = sharded_dibr_rasterization(
        mesh, height, width, torch.from_numpy(fvz), fvi_t,
        torch.from_numpy(feats), torch.from_numpy(nz))
    outs[1].to_local().sum().backward()
    grad = fvi_t.grad.clone()
    dist.all_reduce(grad)
    return [_full(o) for o in outs] + [grad.numpy()]


def job_mlp(mesh, params, pts, yms, prs, rhos, tfms=None, seed=0,
            batch_size=4):
    """One step from ``params``; with ``tfms``, the step's draw returns
    them (the JAX package's draw from the same key), else it draws from a
    CPU generator seeded ``seed``."""
    from kaolin_tpu_torch.parallel import simplicits as ps
    draw = ps._draw_transforms
    if tfms is not None:
        ps._draw_transforms = lambda *a: torch.from_numpy(tfms)
    try:
        new, loss = ps.sharded_mlp_train_step(
            mesh, [{k: torch.from_numpy(v) for k, v in p.items()}
                   for p in params],
            *(torch.from_numpy(x) for x in (pts, yms, prs, rhos)),
            appx_vol=1.0, generator=torch.Generator().manual_seed(seed),
            batch_size=batch_size)
    finally:
        ps._draw_transforms = draw
    return ([{k: v.numpy() for k, v in p.items()} for p in new],
            float(loss))


def job_draw(mesh, seed, batch_size, num_handles):
    """The port's own draw, twice from a generator seeded ``seed``."""
    from kaolin_tpu_torch.parallel import simplicits as ps
    return [ps._draw_transforms(torch.Generator().manual_seed(seed),
                                batch_size, num_handles, "cpu").numpy()
            for _ in range(2)]


def _deformed(scenes, z, sizes):
    out = []
    for s, zi, n in zip(scenes, z, sizes):
        s.sim_z = torch.from_numpy(zi)
        out.append(s.get_object_deformed_pts(0)[:n].numpy())
    return out


def job_demo_batch(mesh, seeds, steps):
    """``make_demo_scene`` of each seed, ``steps`` sharded batch steps →
    each scene's deformed soft-body points and its z."""
    from kaolin_tpu_torch.parallel import (make_demo_scene,
                                           sharded_scene_batch_step)
    scenes = [make_demo_scene(s, device="cpu") for s in seeds]
    state = None
    for _ in range(steps):
        state = sharded_scene_batch_step(mesh, scenes, state=state)
    z = _full(state[0])
    return _deformed(scenes, z, [32] * len(seeds)), z


def scene_of(arrays, pad=None, collisions=False):
    """``tests/parallel/test_heterogeneous_batch.py``'s ``_scene`` in the
    port, on the CPU: the object of ``arrays`` (``SkinnedPhysicsPoints``
    keywords), padded to ``pad`` = (points, handles) first, with QR,
    gravity, a floor at y = −1 and, with ``collisions``, grid contact of
    radius 0.15 and 256 pairs."""
    from kaolin_tpu_torch.parallel.simplicits import (
        pad_skinned_physics_points)
    from kaolin_tpu_torch.physics.simplicits import (SimplicitsScene,
                                                     SkinnedPhysicsPoints)
    baked = SkinnedPhysicsPoints(**arrays)
    if pad is not None:
        baked = pad_skinned_physics_points(baked, *pad)
    scene = SimplicitsScene(timestep=0.03, max_newton_steps=3,
                            max_ls_steps=5, device="cpu")
    scene.add_object(baked, apply_qr=True, normalize_weights_by_samples=True)
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0)
    if collisions:
        scene.enable_collisions(collision_particle_radius=0.15,
                                max_contact_pairs=256, broad_phase="grid")
    return scene


def job_padded_batch(mesh, arrays, pad, steps):
    """Scenes of ``arrays`` padded to ``pad``, ``steps`` sharded batch
    steps → each scene's real deformed points."""
    from kaolin_tpu_torch.parallel import sharded_scene_batch_step
    scenes = [scene_of(a, pad) for a in arrays]
    state = None
    for _ in range(steps):
        state = sharded_scene_batch_step(mesh, scenes, state=state)
    return _deformed(scenes, _full(state[0]),
                     [a["pts"].shape[0] for a in arrays])


def run(rank, world, init_file, jobs, out_path, threads):
    torch.set_num_threads(threads)
    # a fresh process's first torch.exp on the CPU can be off in its last
    # bits, without jax too (ROADMAP F7): warm it on one thread first, as
    # tests/torch_parity.py's warm_torch_exp does for the test modules
    torch.exp(torch.zeros(8))
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
        results = {name: globals()[f"job_{kind}"](mesh, **kw)
                   for name, (kind, kw) in jobs.items()}
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "kaolin_tpu"))
        every = [None] * world
        dist.all_gather_object(every, loaded)
        results["loaded"] = every
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
