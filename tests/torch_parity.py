"""Shared pieces of the kaolin_tpu_torch parity tests (``test_torch_*.py``)."""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """torch's threads shared out among the pytest workers for a module
    (``PYTEST_XDIST_WORKER_COUNT``; all of them in a single process),
    restored after. With every worker on every core's threads, a module of
    long float64 and traversal work oversubscribes the cores: the
    densifier's carve ran 40 times longer under six workers. Import this
    fixture into a test module to apply it there."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def warm_torch_exp():
    """Run torch.exp once on a tensor small enough for one thread.

    With jax imported in the same process, torch 2.13's first ``torch.exp``
    on a CPU tensor large enough to be split over threads returned values up
    to 1e-4 off in 4 of 30 fresh processes; later calls were exact. A first
    call on one thread avoided it in 30 of 30. Import this fixture into a
    test module to apply it there."""
    torch.exp(torch.zeros(8))


@pytest.fixture(scope="module")
def jax_unoptimized():
    """XLA's optimizations off for a module's JAX references, restored
    after. An eager JAX call compiles each op on first use; without the
    optimizations each compiles faster, and one op has nothing to fuse, so
    its result is the same. Import this fixture into a test module and
    name it in ``pytestmark`` to apply it there."""
    import jax

    optimized = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)


def grid_faces(n=4, step=0.125):
    """A grid of n x n square cells, each split along a diagonal →
    (1, 2n², 3, 2) float32. At 32² every pixel centre on a diagonal sits on
    an edge two faces share, where their z and their distance candidates
    tie exactly."""
    faces = []
    for i in range(n):
        for j in range(n):
            x0, y0 = (i - n / 2) * step, (j - n / 2) * step
            a, b = (x0, y0), (x0 + step, y0)
            c, d = (x0, y0 + step), (x0 + step, y0 + step)
            faces += [[a, b, d], [a, d, c]]
    return np.asarray(faces, np.float32)[None]


def load_example(name="torch_dibr_optimization"):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_contact_scene(seed, n_per_obj=60, n_obj=3, spread=1.0):
    """``tests/physics/test_collisions.py``'s ``_random_scene`` in numpy:
    ``n_obj`` clouds of ``n_per_obj`` points around seeded centres and a
    seeded displacement → (dx, x0, obj_ids), float32 and int32."""
    rng = np.random.RandomState(seed)
    pts, ids = [], []
    for o in range(n_obj):
        center = rng.uniform(-spread, spread, (3,))
        pts.append(center + rng.uniform(-0.3, 0.3, (n_per_obj, 3)))
        ids.append(np.full(n_per_obj, o))
    x0 = np.concatenate(pts).astype(np.float32)
    obj_ids = np.concatenate(ids).astype(np.int32)
    dx = rng.uniform(-0.2, 0.2, x0.shape).astype(np.float32)
    return dx, x0, obj_ids


def pair_set(contacts):
    """The unordered valid pairs of a contact buffer (either package)."""
    ia = np.asarray(contacts.indices_a)
    ib = np.asarray(contacts.indices_b)
    valid = np.asarray(contacts.valid)
    return {tuple(sorted((int(a), int(b))))
            for a, b, v in zip(ia, ib, valid) if v}


def qr_blocks(scene, name):
    """A scene's block-diagonal ``qr_tfm`` or ``qr_tfm_inv`` in float64, the
    identity for objects without the QR (either package)."""
    import scipy.linalg

    blocks = []
    for o in scene.sim_obj_dict.values():
        m = getattr(o, name)
        blocks.append(np.eye(12 * o.num_handles) if m is None
                      else np.asarray(m, np.float64))
    return scipy.linalg.block_diag(*blocks)


def z_converter(port_scene, jax_scene):
    """JAX's z (numpy) → the port's z in its own basis, through the pre-QR
    basis in float64 (the two may take other QR pivots)."""
    conv = qr_blocks(port_scene, "qr_tfm_inv") @ qr_blocks(jax_scene,
                                                           "qr_tfm")
    return lambda z: torch.from_numpy(
        (conv @ np.asarray(z, np.float64)).astype(np.float32))


def displacement(scene, z):
    """B z in float64: the points' displacement, whatever the basis."""
    return np.asarray(scene.sim_B, np.float64) @ np.asarray(z, np.float64)


# -- gaussians and Bayesian-fusion carving ---------------------------------
_JAX_VOXELS = {}


@contextlib.contextmanager
def jax_voxels_memoized():
    """kaolin_tpu's ``gs_to_voxelgrid``, as its densifier calls it,
    memoized on its inputs' bytes for the duration: the JAX float64
    voxelization of a 300-gaussian shell at level 6 takes seconds, and the
    densifier's floodfill, carve and scene tests voxelize the same shell."""
    import kaolin_tpu.ops.gaussians.densifier as jd

    orig = jd.gs_to_voxelgrid

    def memo(xyz, scales, rots, opacities, level, **kw):
        key = (tuple(np.asarray(a).tobytes() for a in
                     (xyz, scales, rots, opacities)), level,
               tuple(sorted(kw.items())))
        if key not in _JAX_VOXELS:
            _JAX_VOXELS[key] = orig(xyz, scales, rots, opacities, level,
                                    **kw)
        return _JAX_VOXELS[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "gs_to_voxelgrid", memo)
        yield


@contextlib.contextmanager
def jax_without_contraction():
    """The JAX package's arithmetic without its two roundings that the port
    does not make (ROADMAP Queue C, F24): XLA's optimizations off, which
    contract the Bayesian-fusion profile's Bezier into fused multiply-adds,
    and ``jax.lax.rsqrt`` as ``1 / sqrt``, where XLA's CPU rsqrt is within
    an ulp of it but not correctly rounded."""
    import jax
    import jax.numpy as jnp

    optimized = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", optimized)


def frame_tuple(frame, to_numpy):
    """A ``RayTracedSPCDataset`` frame with its tensors as numpy arrays
    (``to_numpy``) or as they are."""
    return tuple(x.numpy() if to_numpy and isinstance(x, torch.Tensor)
                 else x for x in frame)


_FRAMES = {}


@contextlib.contextmanager
def shared_carving_views(res):
    """Both packages' densifiers carve from the same frames: the port's
    ``RayTracedSPCDataset`` of the shell at ``res`` (views of 2^res pixels a
    side), handed to the JAX package as numpy. The dataset itself is held
    against the JAX package's in ``tests/test_torch_spc_more.py``; sharing
    its frames keeps the JAX raytrace, seconds a view on the CPU, out of
    the densifier's test."""
    import kaolin_tpu.ops.spc as jspc

    import kaolin_tpu_torch.ops.spc as tspc

    port_dataset = tspc.RayTracedSPCDataset

    def views(to_numpy):
        def make(viewpoints, gs_octree, res_=None):
            octree = np.array(gs_octree)
            key = (octree.tobytes(), np.asarray(viewpoints).tobytes(), res)
            if key not in _FRAMES:
                ds = port_dataset(viewpoints, torch.from_numpy(octree),
                                  res=res)
                _FRAMES[key] = [ds[i] for i in range(len(ds))]
            return [frame_tuple(f, to_numpy) for f in _FRAMES[key]]
        return make

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspc, "RayTracedSPCDataset", views(True))
        mp.setattr(tspc, "RayTracedSPCDataset", views(False))
        yield


CARVE_VIEWS = np.array([      # tests/ops/test_gaussians.py's eight views
    [4.0, 0, 0.3], [-4.0, 0, 0.3], [0, 4.0, 0.3], [0, -4.0, 0.3],
    [0.3, 0.3, 4.0], [0.3, 0.3, -4.0],
    [2.3, 2.3, 2.3], [-2.3, -2.3, -2.3]], dtype=np.float32)
