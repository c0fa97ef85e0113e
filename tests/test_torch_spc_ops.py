"""kaolin_tpu_torch SPC ops against kaolin_tpu's, on the CPU.

The same numpy points go to both packages. Everything here is integer or
exact: Morton codes, quantized points, octree bytes, pyramids, exsum and
point hierarchies must be equal. The port builds octrees by the JAX
package's numpy route; they are held against both of its routes, the
native C++ builder and numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.native
from kaolin_tpu.ops import spc as spc_jax
from kaolin_tpu_torch.ops import spc
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)


def eq(port, jax_value):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))


def shell_points(level, seed, n=3000):
    """Quantized points of two noisy shells and some dust, (Q, 3) int16."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.concatenate([d * 0.6, d * 0.3 + 0.1,
                          rng.uniform(-1, 1, (200, 3))]).astype(np.float32)
    grid = 2 ** level
    return np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                   grid - 1).astype(np.int16)


@pytest.mark.parametrize("level", [1, 3, 6, 9])
def test_morton_and_quantize_match_jax(level):
    rng = np.random.RandomState(level)
    x = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    q = spc.quantize_points(torch.from_numpy(x), level)
    eq(q, spc_jax.quantize_points(jnp.asarray(x), level))
    m = spc.points_to_morton(q)
    assert m.dtype == torch.int64
    eq(m, spc_jax.points_to_morton(np.asarray(q)))
    eq(spc.morton_to_points(m), spc_jax.morton_to_points(np.asarray(m)))
    eq(spc.morton_to_points(m), q)
    eq(spc.points_to_corners(q),
       spc_jax.points_to_corners(jnp.asarray(q.numpy())))


def test_uint8_helpers_match_jax():
    b = np.arange(256, dtype=np.uint8)
    bits = spc.uint8_to_bits(torch.from_numpy(b))
    eq(bits, spc_jax.uint8_to_bits(jnp.asarray(b)))
    eq(spc.uint8_bits_sum(torch.from_numpy(b)),
       spc_jax.uint8_bits_sum(jnp.asarray(b)))
    eq(spc.bits_to_uint8(bits), b)


@pytest.mark.parametrize("level,seed", [(2, 0), (5, 1), (8, 2)])
def test_octree_scan_and_points_match_jax(level, seed, monkeypatch):
    pts = shell_points(level, seed)
    octree = spc.unbatched_points_to_octree(pts, level, device="cpu")
    assert octree.dtype == torch.uint8 and octree.device.type == "cpu"
    eq(octree, spc_jax.unbatched_points_to_octree(jnp.asarray(pts), level))
    native = kaolin_tpu.native.points_to_octree(pts, level)
    if native is not None:               # None where g++ is missing
        eq(octree, native)
    with monkeypatch.context() as m:     # the JAX package's numpy route
        m.setattr(kaolin_tpu.native, "is_available", lambda: False)
        eq(octree, spc_jax.unbatched_points_to_octree(jnp.asarray(pts),
                                                      level))
    codes = np.unique(np.asarray(spc_jax.points_to_morton(pts)))
    eq(spc.morton_to_octree(torch.from_numpy(codes), level), octree)

    lengths = torch.tensor([len(octree)], dtype=torch.int32)
    for legacy in (False, True):
        ml, pyr, exsum = spc.scan_octrees(octree, lengths, legacy)
        ml_j, pyr_j, exsum_j = spc_jax.scan_octrees(
            jnp.asarray(octree.numpy()), np.asarray(lengths), legacy)
        assert ml == ml_j == level
        eq(pyr, pyr_j)
        eq(exsum, exsum_j)
    ml, pyr, exsum = spc.scan_octrees(octree, lengths)
    ph = spc.generate_points(octree, pyr, exsum)
    assert ph.dtype == torch.int16
    eq(ph, spc_jax.generate_points(jnp.asarray(octree.numpy()),
                                   np.asarray(pyr), np.asarray(exsum)))
    top = spc.unbatched_get_level_points(ph, pyr[0], level)
    eq(top, spc_jax.unbatched_get_level_points(np.asarray(ph),
                                               np.asarray(pyr)[0], level))
    assert len(top) == len(np.unique(pts, axis=0))


def test_batched_scan_matches_jax():
    trees = [spc.unbatched_points_to_octree(shell_points(lv, lv), lv,
                                            device="cpu")
             for lv in (3, 4)]
    octrees = torch.cat(trees)
    lengths = torch.tensor([len(t) for t in trees], dtype=torch.int32)
    ml, pyr, exsum = spc.scan_octrees(octrees, lengths)
    ml_j, pyr_j, exsum_j = spc_jax.scan_octrees(
        jnp.asarray(octrees.numpy()), np.asarray(lengths))
    assert ml == ml_j == 4
    eq(pyr, pyr_j)
    eq(exsum, exsum_j)
    eq(spc.generate_points(octrees, pyr, exsum),
       spc_jax.generate_points(jnp.asarray(octrees.numpy()),
                               np.asarray(pyr), np.asarray(exsum)))


def section_a_calls():
    """Each SPC and mesh op that builds on the host, as (name, call of
    (inputs as given, device))."""
    from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
    from kaolin_tpu_torch.ops.mesh import adjacency_matrix, uniform_laplacian
    from kaolin_tpu_torch.render.spc.raster import build_raster_spc
    pts = shell_points(4, 0)
    octree = spc.unbatched_points_to_octree(pts, 4, device="cpu").numpy()
    _, pyr, ex = spc.scan_octrees(octree, np.array([len(octree)]),
                                  device="cpu")
    ph = spc.generate_points(octree, pyr, ex, device="cpu").numpy()
    codes = np.unique(spc.points_to_morton(pts, "cpu").numpy())
    grid = np.random.RandomState(1).rand(1, 2, 5, 6, 4).astype(np.float32)
    grid[grid < 0.5] = 0.0
    cloud = np.random.RandomState(2).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [1, 3, 2]])
    return [
        ("points_to_morton", lambda a, d: spc.points_to_morton(a(pts), d)),
        ("morton_to_points", lambda a, d: spc.morton_to_points(a(codes), d)),
        ("unbatched_points_to_octree",
         lambda a, d: spc.unbatched_points_to_octree(a(pts), 4, device=d)),
        ("morton_to_octree",
         lambda a, d: spc.morton_to_octree(a(codes), 4, device=d)),
        ("scan_octrees", lambda a, d: spc.scan_octrees(
            a(octree), a(np.array([len(octree)])), device=d)[1:]),
        ("generate_points", lambda a, d: spc.generate_points(
            a(octree), a(pyr.numpy()), a(ex.numpy()), device=d)),
        ("feature_grids_to_spc",
         lambda a, d: spc.feature_grids_to_spc(a(grid), device=d)),
        ("unbatched_pointcloud_to_spc", lambda a, d: (
            lambda s: (s.octrees, s.lengths, s.features))(
                unbatched_pointcloud_to_spc(a(cloud), 4, a(cloud),
                                            device=d))),
        ("adjacency_matrix",
         lambda a, d: adjacency_matrix(4, a(faces), device=d)),
        ("uniform_laplacian",
         lambda a, d: uniform_laplacian(4, a(faces), device=d)),
        ("build_raster_spc", lambda a, d: tuple(build_raster_spc(
            a(ph), a(pyr[0].numpy()), 4, device=d))),
    ]


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for x in out for t in _tensors(x)] if isinstance(
        out, (list, tuple)) else []


def same(a, b, name):
    """Equal bit for bit, NaN padding included."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                               msg=name)


def test_spc_and_mesh_ops_default_to_the_card():
    """Given host arrays and no ``device``, each op builds on the card, and
    raises where there is none; ``device="cpu"`` builds on the CPU; a CPU
    tensor's device is kept, with the same values."""
    host_in = np.asarray
    for name, call in section_a_calls():
        on_cpu = _tensors(call(host_in, "cpu"))
        assert on_cpu and all(t.device.type == "cpu" for t in on_cpu), name
        kept = _tensors(call(torch.as_tensor, None))
        assert all(t.device.type == "cpu" for t in kept), name
        for a, b in zip(kept, on_cpu):
            same(a, b, name)
        if torch.cuda.is_available():
            on_card = _tensors(call(host_in, None))
            assert all(t.is_cuda for t in on_card), name
            for a, b in zip(on_card, on_cpu):
                same(a.cpu(), b, name)
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call(host_in, None)
