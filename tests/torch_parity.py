"""Shared pieces of the kaolin_tpu_torch parity tests (``test_torch_*.py``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def warm_torch_exp():
    """Run torch.exp once on a tensor small enough for one thread.

    With jax imported in the same process, torch 2.13's first ``torch.exp``
    on a CPU tensor large enough to be split over threads returned values up
    to 1e-4 off in 4 of 30 fresh processes; later calls were exact. A first
    call on one thread avoided it in 30 of 30. Import this fixture into a
    test module to apply it there."""
    torch.exp(torch.zeros(8))


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
