"""kaolin_tpu_torch's point-cloud and mesh ops against kaolin_tpu's, on the
CPU: farthest-point sampling (indices exactly equal, with inf and NaN rows
and repeated points), ``center_points`` (rtol 1e-6) and ``check_sign``
(booleans exactly equal on a closed torus: both packages take the same
float32 operations in the same order, so only a candidate within rounding
of a face, or a ray within rounding of an edge, could part them; none of
these draws does).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops.mesh.check_sign import check_sign as check_sign_jax
from kaolin_tpu.ops.pointcloud import center_points as center_points_jax
from kaolin_tpu.ops.pointcloud import (
    farthest_point_sampling as fps_jax,
)
from kaolin_tpu_torch.ops import (
    center_points,
    check_sign,
    farthest_point_sampling,
)
from tests.torch_parity import load_example
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

train = load_example("torch_simplicits_train")


def fps_cloud(seed, n=400):
    """Two seeded clouds of ``n`` points with an inf row, a −inf row, a NaN
    coordinate and ten copies of one point (ties) → (2, n, 3) float32."""
    rng = np.random.RandomState(seed)
    p = rng.randn(2, n, 3).astype(np.float32)
    p[0, 7] = np.inf
    p[0, 100, 2] = -np.inf
    p[1, 3, 1] = np.nan
    p[1, 10:20] = p[1, 5]
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_fps_indices_equal_jax(seed):
    p = fps_cloud(seed)
    for k in (1, 64, 397, 400):
        want = np.asarray(fps_jax(jnp.asarray(p), k))
        got = farthest_point_sampling(torch.from_numpy(p), k)
        assert got.dtype == torch.int32 and got.shape == (2, k)
        np.testing.assert_array_equal(got.numpy(), want)
    # the non-finite rows come last, each once
    idx = farthest_point_sampling(torch.from_numpy(p), 400).numpy()
    assert set(idx[0, -2:]) == {7, 100} and idx[1, -1] == 3
    assert all(len(set(row)) == 400 for row in idx)


def test_fps_rejects_bad_shapes():
    with pytest.raises(ValueError, match="shape"):
        farthest_point_sampling(torch.zeros(10, 3), 2)
    with pytest.raises(ValueError, match="k = 11"):
        farthest_point_sampling(torch.zeros(1, 10, 3), 11)


@pytest.mark.parametrize("normalize", [False, True])
def test_center_points_matches_jax(normalize):
    p = (np.random.RandomState(2).rand(3, 50, 3) * 4 - 1).astype(np.float32)
    want = np.asarray(center_points_jax(jnp.asarray(p), normalize))
    got = center_points(torch.from_numpy(p), normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_check_sign_matches_jax_on_the_torus():
    """The torus at 16 x 8 segments, 2,000 candidates in its box."""
    verts, faces = train.torus_mesh((16, 8), device="cpu")
    cand = train.candidates(verts, 2000, seed=0)
    want = np.asarray(check_sign_jax(jnp.asarray(verts.numpy())[None],
                                     jnp.asarray(faces.numpy()),
                                     jnp.asarray(cand.numpy())[None]))
    got = check_sign(verts[None], faces, cand[None])
    assert got.dtype == torch.bool and got.shape == (1, 2000)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.35 < want.mean() < 0.6
    # two meshes in one batch, the second twice as large (the normalization
    # by the largest box side gives it the first's numbers bit for bit)
    v2 = torch.stack([verts, verts * 2])
    p2 = torch.stack([cand, cand * 2])
    np.testing.assert_array_equal(check_sign(v2, faces, p2).numpy(),
                                  np.concatenate([want, want]))


def test_check_sign_tiles_give_one_answer(monkeypatch):
    """The face tiles (here 7 faces, a tile count that does not divide the
    256 faces) leave the answer as it is."""
    mod = importlib.import_module("kaolin_tpu_torch.ops.mesh.check_sign")
    verts, faces = train.torus_mesh((16, 8), device="cpu")
    cand = train.candidates(verts, 500, seed=3)[None]
    whole = check_sign(verts[None], faces, cand)
    monkeypatch.setattr(mod, "_TILE_ELEMENTS", 7 * 500)
    np.testing.assert_array_equal(check_sign(verts[None], faces, cand),
                                  whole)


def test_check_sign_native_backend_is_not_ported():
    """``backend="native"`` (the host C++ TriangleHash) gives JAX's native
    answer and JAX's XLA answer on the torus's candidates, B = 2; an
    unknown backend raises ValueError. (The name is the one the test had
    while the backend raised.)"""
    verts, faces = train.torus_mesh((16, 8), device="cpu")
    cand = torch.stack([train.candidates(verts, 2000, seed=s)
                        for s in (0, 1)])
    v2 = torch.stack([verts, verts * 1.5])
    got = check_sign(v2, faces, cand, backend="native")
    args = (jnp.asarray(v2.numpy()), jnp.asarray(faces.numpy()),
            jnp.asarray(cand.numpy()))
    assert got.dtype == torch.bool and got.shape == (2, 2000)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(check_sign_jax(*args, backend="native")))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(check_sign_jax(*args)))
    with pytest.raises(ValueError, match="backend"):
        check_sign(verts[None], faces, verts[None], backend="warp")
