"""The rest of kaolin_tpu_torch's ``ops/spc``, ``rep/spc.py`` and the SPC
conversions against kaolin_tpu's, on the CPU: ``exsum_compat``,
trilinear interpolation, queries, the dense bridges, the dual octree and
its trinkets, the ``Spc`` container, point-cloud and mesh conversions, the
sparse convolutions and ``RayTracedSPCDataset``.

The same numpy inputs go to both packages. Integer results (octrees,
pyramids, exsums, query indices, duals, trinkets, parents, neighbour maps,
occupancy) are exactly equal, and ``unbatched_mesh_to_spc``'s octree bit
for bit. Float results are within 1e-6 relative (the trilinear and
convolution contractions sum in another order than XLA's), gradients within
1e-5 of the largest entry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.ops.conversions as conv_jax
import kaolin_tpu.ops.spc as spc_jax
import kaolin_tpu.rep as rep_jax
from kaolin_tpu.ops.spc import exsum_compat as exsum_jax
from kaolin_tpu_torch.ops import conversions
from kaolin_tpu_torch.ops import spc
from kaolin_tpu_torch.ops.spc import exsum_compat
from kaolin_tpu_torch.rep import Spc
from kaolin_tpu_torch.utils.interop import spc_conv_params_from_jax
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

REL, GRAD_TOL = 1e-6, 1e-5
EX = load_example("torch_spc_raytrace")


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def eq(port, want):
    np.testing.assert_array_equal(torch.as_tensor(port).detach().numpy(),
                                  np.asarray(want))


def close(port, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(port.detach().numpy(), want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()))


def grad_close(port_grad, want_grad):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(port_grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


@pytest.fixture(scope="module")
def scene():
    """The example's mesh at level 6: the port's scene and JAX's octree,
    exsum, point hierarchy and pyramid."""
    port = EX.spc_scene(6, "cpu")
    oj = jnp.asarray(port["octree"].numpy())
    _, pyr, ex = spc_jax.scan_octrees(oj, np.array([len(oj)], np.int32))
    ph = spc_jax.generate_points(oj, pyr, ex)
    return port, (oj, ex, ph, np.asarray(pyr))


def test_exports_match_jax():
    """Every name ``kaolin_tpu.ops.spc`` and ``kaolin_tpu.render.spc``
    export, the port's packages export too, ``bf_recon``'s five with them;
    the conversions export the names of the two modules ported; ``rep``
    exports the JAX package's names, ``SurfaceMesh`` among them."""
    import kaolin_tpu.render.spc as render_jax
    import kaolin_tpu_torch.render.spc as render_port

    for jmod, tmod in ((spc_jax, spc), (render_jax, render_port)):
        names = {n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(os))}
        missing = sorted(n for n in names if not hasattr(tmod, n))
        assert not missing, missing
    assert all(hasattr(spc, n) for n in ("bf_recon", "build_mip2d",
                                         "extract_bq", "fuse_bf",
                                         "process_frame"))
    for name in ("pointclouds_to_voxelgrids", "unbatched_pointcloud_to_spc",
                 "trianglemeshes_to_voxelgrids", "unbatched_mesh_to_spc"):
        assert hasattr(conv_jax, name) and hasattr(conversions, name)
    import kaolin_tpu_torch.rep as rep

    def exported(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(os))}
    assert exported(rep) == exported(rep_jax)
    assert "Spc" in exported(rep)


def test_exsum_compat_matches_jax():
    lengths = np.array([5, 3, 7])
    rng = np.random.RandomState(0)
    ex = rng.randint(1, 50, lengths.sum()).astype(np.int32)
    legacy = exsum_jax.current_to_legacy(ex, lengths)
    eq(exsum_compat.current_to_legacy(t(ex), t(lengths)), legacy)
    eq(exsum_compat.current_to_legacy(ex, lengths), legacy)
    with pytest.warns(DeprecationWarning):
        eq(exsum_compat.ensure_current_exsum(t(legacy), lengths, "f"), ex)
    eq(exsum_compat.ensure_current_exsum(t(ex), lengths, "f"), ex)
    eq(exsum_compat._legacy_to_current(legacy[:6], [5]),
       exsum_jax._legacy_to_current(legacy[:6], [5]))
    with pytest.raises(ValueError, match="neither"):
        exsum_compat.ensure_current_exsum(t(ex[:-1]), lengths, "f")
    octree = spc.unbatched_points_to_octree(
        np.array([[0, 1, 2], [3, 3, 3], [7, 0, 5]]), 3, device="cpu")
    _, pyr, _ = spc.scan_octrees(torch.cat([octree, octree]),
                                 torch.tensor([len(octree)] * 2))
    eq(exsum_compat.octree_byte_lengths_from_pyramid(pyr),
       exsum_jax.octree_byte_lengths_from_pyramid(pyr.numpy()))


def test_trilinear_matches_jax(scene):
    """Coefficients and interpolated features at the leaf and two coarser
    levels, misses giving zeros, and the gradients in coords and
    features."""
    port, (_, _, phj, pyrj) = scene
    rng = np.random.RandomState(1)
    n_pts = 200
    feats = rng.randn(port["dual"].shape[0], 5).astype(np.float32)
    w = rng.randn(n_pts, 2, 5).astype(np.float32)
    dj, pdj = spc_jax.unbatched_make_dual(phj, pyrj[0])
    trj, _ = spc_jax.unbatched_make_trinkets(phj, pyrj[0], dj, pdj)
    for level in (6, 5, 4):
        start, num = (int(x) for x in pyrj[0, [1, 0], level])
        pidx = (start + rng.randint(0, num, n_pts)).astype(np.int32)
        pidx[::17] = -1
        cells = np.asarray(phj)[np.maximum(pidx, 0)].astype(np.float32)
        coords = ((cells[:, None] + rng.uniform(0, 1, (n_pts, 2, 3)))
                  / 2 ** level * 2 - 1).astype(np.float32)
        close(spc.coords_to_trilinear_coeffs(t(coords), t(cells[:, None]),
                                             level),
              spc_jax.coords_to_trilinear_coeffs(jnp.asarray(coords),
                                                 cells[:, None], level))
        x, f = t(coords).requires_grad_(True), t(feats).requires_grad_(True)
        out = spc.unbatched_interpolate_trilinear(
            x, t(pidx), port["point_hierarchy"], port["trinkets"], f, level)
        (out * t(w)).sum().backward()

        def fj(x, f):
            return spc_jax.unbatched_interpolate_trilinear(
                x, jnp.asarray(pidx), phj, trj, f, level)
        want, (gx, gf) = jax.jit(lambda x, f: (fj(x, f), jax.grad(
            lambda x, f: jnp.sum(fj(x, f) * w), argnums=(0, 1))(x, f)))(
                jnp.asarray(coords), jnp.asarray(feats))
        close(out, want)
        assert (out[torch.from_numpy(pidx < 0)] == 0).all()
        grad_close(x.grad, gx)
        grad_close(f.grad, gf)
    with pytest.warns(DeprecationWarning):
        close(spc.coords_to_trilinear(t(coords), t(cells[:, None]), 4),
              spc_jax.coords_to_trilinear_coeffs(jnp.asarray(coords),
                                                 cells[:, None], 4))


def test_dual_and_trinkets_match_jax(scene):
    port, (_, _, phj, pyrj) = scene
    dj, pdj = spc_jax.unbatched_make_dual(phj, pyrj[0])
    trj, parj = spc_jax.unbatched_make_trinkets(phj, pyrj[0], dj, pdj)
    for p, j in ((port["dual"], dj), (port["pyramid_dual"], pdj),
                 (port["trinkets"], trj), (port["parents"], parj)):
        assert p.dtype == torch.from_numpy(np.array(j)).dtype
        eq(p, j)


def test_query_matches_jax(scene):
    """Float and integer coords, out-of-range coords, and every level's
    parents; occupied leaves query back to themselves."""
    port, (oj, exj, phj, pyrj) = scene
    rng = np.random.RandomState(2)
    x = rng.uniform(-1.1, 1.1, (500, 3)).astype(np.float32)
    leaves = np.asarray(phj)[pyrj[0, 1, 6]:]
    xi = np.concatenate([leaves[:100], rng.randint(-2, 66, (100, 3))])
    query_j = jax.jit(spc_jax.unbatched_query, static_argnums=(3, 4))
    for q in (x, xi.astype(np.int32)):
        for parents in (False, True):
            eq(spc.unbatched_query(port["octree"], port["exsum"], t(q), 6,
                                   parents),
               query_j(oj, exj, jnp.asarray(q), 6, parents))
    idx = spc.unbatched_query(port["octree"], port["exsum"],
                              t(leaves[:100].astype(np.int32)), 6)
    eq(idx, pyrj[0, 1, 6] + np.arange(100))


def test_dense_bridges_match_jax():
    """``to_dense`` (and its gradient) of a batch of two, and
    ``feature_grids_to_spc`` with and without masks, on grids of a side
    that is not a power of two and one that is empty."""
    rng = np.random.RandomState(3)
    grids = rng.randn(3, 2, 5, 6, 7).astype(np.float32)
    grids[:, :, rng.rand(5, 6, 7) < 0.7] = 0.0
    grids[2] = 0.0
    masks = rng.rand(3, 5, 6, 7) < 0.3
    for m in (None, masks):
        port = spc.feature_grids_to_spc(t(grids), None if m is None else t(m))
        want = spc_jax.feature_grids_to_spc(jnp.asarray(grids), m)
        for p, j in zip(port, want):
            eq(p, j)
    octrees, lengths, feats = port[:2] + (port[2],)
    _, pyr, ex = spc.scan_octrees(octrees[:lengths[:2].sum()], lengths[:2])
    ph = spc.generate_points(octrees[:lengths[:2].sum()], pyr, ex)
    n = int(pyr[:, 0, -2].sum())
    x = t(rng.randn(n, 4).astype(np.float32)).requires_grad_(True)
    w = rng.randn(2, 4, 8, 8, 8).astype(np.float32)
    out = spc.to_dense(ph, pyr, x)
    (out * t(w)).sum().backward()

    def fj(x):
        y = spc_jax.to_dense(jnp.asarray(ph.numpy()), pyr.numpy(), x)
        return jnp.sum(y * w), y
    (_, want), g = jax.jit(jax.value_and_grad(fj, has_aux=True))(
        jnp.asarray(x.detach().numpy()))
    close(out, want)
    grad_close(x.grad, g)


def test_dense_spc_and_container_match_jax():
    octree, lengths = spc.create_dense_spc(3)
    oj, lj = spc_jax.create_dense_spc(3)
    eq(octree, oj)
    eq(lengths, lj)
    grids = np.random.RandomState(4).randn(1, 3, 4, 4, 4).astype(np.float32)
    grids[0, :, :2] = 0
    s, feats = Spc.from_features(t(grids))
    sj, fj = rep_jax.Spc.from_features(jnp.asarray(grids))
    eq(feats, fj)
    for spc_p, spc_j in ((s, sj), (Spc.make_dense(2), rep_jax.Spc.make_dense(2)),
                         (Spc.from_list([octree, octree[:1]]),
                          rep_jax.Spc.from_list([oj, oj[:1]]))):
        assert spc_p.max_level == spc_j.max_level
        for key in ("octrees", "lengths", "pyramids", "exsum",
                    "point_hierarchies"):
            eq(getattr(spc_p, key), getattr(spc_j, key))
        eq(spc_p.num_points(1), spc_j.num_points(1))
        assert len(spc_p) == len(spc_j) and repr(spc_p) == repr(spc_j)
        assert spc_p.to_dict().keys() == spc_j.to_dict().keys()
    with pytest.raises(ValueError):
        Spc.from_list([])
    with pytest.raises(ValueError):
        Spc.make_dense(0)


def test_pointcloud_conversions_match_jax():
    """Occupancy grids with points at .5 (half to even) and outside the
    box; the SPC of a cloud with float and integer features."""
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    pts[0, :4] = [[0.125, 0.375, 0.625]] * 4
    for kw in (dict(), dict(origin=t(pts.min(1)) - 0.1,
                            scale=t(np.full(2, 1.5, np.float32)))):
        port = conversions.pointclouds_to_voxelgrids(t(pts), 9, **kw)
        want = conv_jax.pointclouds_to_voxelgrids(
            jnp.asarray(pts), 9, **{k: jnp.asarray(v.numpy())
                                    for k, v in kw.items()})
        eq(port, want)
    with pytest.raises(TypeError):
        conversions.pointclouds_to_voxelgrids(t(pts), 9.0)
    cloud = pts[1]
    for feats in (rng.randn(300, 3).astype(np.float32),
                  rng.randint(0, 255, (300, 3)).astype(np.int32)):
        port = conversions.unbatched_pointcloud_to_spc(t(cloud), 4, t(feats))
        want = conv_jax.unbatched_pointcloud_to_spc(jnp.asarray(cloud), 4,
                                                    jnp.asarray(feats))
        eq(port.octrees, want.octrees)
        eq(port.lengths, want.lengths)
        eq(port.features, want.features)


@pytest.mark.parametrize("level", [3, 5, 6])
def test_mesh_to_spc_matches_jax(level):
    """The example's mesh and the icosphere: octree bit for bit, leaf
    points equal."""
    v, f = EX.icosphere()
    for fv in (EX.mesh_faces(), v[f]):
        octree, points = conversions.unbatched_mesh_to_spc(t(fv), level)
        oj, pj = conv_jax.unbatched_mesh_to_spc(jnp.asarray(fv), level)
        assert octree.dtype == torch.uint8 and points.dtype == torch.int16
        eq(octree, oj)
        eq(points, pj)


def test_mesh_voxelgrids_match_jax():
    v, f = EX.icosphere()
    verts = np.stack([v, v * 0.5 + 0.1]).astype(np.float32)
    eq(conversions.trianglemeshes_to_voxelgrids(t(verts), t(f), 16),
       conv_jax.trianglemeshes_to_voxelgrids(jnp.asarray(verts),
                                             jnp.asarray(f), 16))


def conv_params(rng, k, cin, cout):
    """JAX-layout convolution parameters drawn with numpy (``init``'s
    shapes and weight bounds; ``jax.random`` would compile once a shape)."""
    s = 1.0 / np.sqrt(cin * k)
    return {"weight": jnp.asarray(rng.uniform(-s, s, (k, cin, cout)).astype(
        np.float32)), "bias": jnp.asarray(rng.randn(cout).astype(np.float32))}


@pytest.mark.parametrize("jump,kernel", [(0, "3x3x3"), (1, "2x2x2"),
                                         (0, "1x1")])
def test_spc_convolutions_match_jax(jump, kernel):
    """``conv3d``/``conv_transpose3d`` and the modules, with JAX's weights
    (``spc_conv_params_from_jax``): outputs within 1e-6 relative, their
    gradients within 1e-5 of max|g|, and the transpose the adjoint."""
    rng = np.random.RandomState(6)
    level = 4
    q = spc.quantize_points(t(rng.uniform(-1, 1, (300, 3)).astype(
        np.float32)), level)
    octree = spc.unbatched_points_to_octree(q, level)
    _, pyr, ex = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    ph = spc.generate_points(octree, pyr, ex)
    topo = (octree, ph, level, pyr, ex)
    topo_j = (jnp.asarray(octree.numpy()), jnp.asarray(ph.numpy()), level,
              pyr.numpy(), jnp.asarray(ex.numpy()))
    r = {"3x3x3": range(-1, 2), "2x2x2": range(2), "1x1": range(1)}[kernel]
    kv = np.array([[i, j, k] for i in r for j in r for k in r])
    n_fine = int(pyr[0, 0, level])
    n_out = int(pyr[0, 0, level - jump])
    mj = spc_jax.Conv3d(3, 4, kv, jump=jump)
    params = conv_params(rng, len(kv), 3, 4)
    m = spc.Conv3d(3, 4, kv, jump=jump)
    m.load_state_dict(spc_conv_params_from_jax(params))
    x = rng.randn(n_fine, 3).astype(np.float32)
    w = rng.randn(n_out, 4).astype(np.float32)
    xt = t(x).requires_grad_(True)
    out, out_level = m(*topo, xt)
    (out * t(w)).sum().backward()
    assert out_level == mj(params, *topo_j, jnp.asarray(x))[1] == level - jump

    def loss_j(p, x):
        # the neighbour map is read from the concrete topology
        with jax.ensure_compile_time_eval():
            y = mj(p, *topo_j, x)[0]
        return jnp.sum(y * w), y
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    close(out, want)
    grad_close(xt.grad, gx)
    grad_close(m.weight.grad, gp["weight"])

    mtj = spc_jax.ConvTranspose3d(4, 3, kv, jump=jump)
    pt = conv_params(rng, len(kv), 4, 3)
    mt = spc.ConvTranspose3d(4, 3, kv, jump=jump)
    mt.load_state_dict(spc_conv_params_from_jax(pt))
    y = rng.randn(n_out, 4).astype(np.float32)
    outt, lt = mt(octree, ph, level - jump, pyr, ex, t(y))
    wantt, ltj = mtj(pt, topo_j[0], topo_j[1], level - jump, topo_j[3],
                     topo_j[4], jnp.asarray(y))
    close(outt, wantt)
    assert lt == ltj == level
    # ⟨conv X, Y⟩ = ⟨X, convᵀ Y⟩ with the weights shared and no bias
    wt = m.weight.detach()
    cx, _ = spc.conv3d(*topo, t(x), wt, kv, jump=jump)
    cty, _ = spc.conv_transpose3d(octree, ph, level - jump, pyr, ex, t(y),
                                  wt.transpose(1, 2), kv, jump=jump)
    lhs, rhs = float((cx * t(y)).sum()), float((t(x) * cty).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


def test_conv_module_init():
    """The weight is uniform in ±1/√(Cin·K) from the generator, the bias
    zeros; the same seed gives the same weight."""
    kv = np.zeros((8, 3), np.int64)
    a = spc.Conv3d(3, 5, kv, generator=torch.Generator().manual_seed(3))
    b = spc.Conv3d(3, 5, kv, generator=torch.Generator().manual_seed(3))
    assert a.weight.shape == (8, 3, 5) and (a.bias == 0).all()
    assert a.weight.abs().max() <= 1 / np.sqrt(24)
    assert torch.equal(a.weight, b.weight)
    assert spc.ConvTranspose3d(3, 5, kv, bias=False).bias is None


def test_raytraced_spc_dataset_matches_jax():
    """Frames of two viewpoints (one along +z, which takes the other up
    vector) at 16²: hit masks and the matrices as JAX's, depths within
    1e-5 relative (the port's look-at translation rounds once where XLA
    contracts it), the points and scalars equal."""
    rng = np.random.RandomState(7)
    q = np.unique(rng.randint(20, 44, (3000, 3)), axis=0).astype(np.int16)
    octree = spc.unbatched_points_to_octree(q, 6, device="cpu")
    views = np.array([[2.0, 1.0, 1.5], [0.0, 0.0, 2.5]], np.float32)
    port = spc.RayTracedSPCDataset(t(views), octree, res=4)
    want = spc_jax.RayTracedSPCDataset(views, jnp.asarray(octree.numpy()),
                                       res=4)
    assert len(port) == len(want) == 2 and port.level == want.level
    for i in range(2):
        p, j = port[i], want[i]
        assert len(p) == len(j) == 10 and p[-1] is j[-1] is True
        eq(p[0], j[0])
        hit = np.asarray(j[1]) < want.max_depth
        eq(p[1].numpy() < port.max_depth, hit)
        close(p[1][torch.from_numpy(hit)], np.asarray(j[1])[hit], 1e-5)
        close(p[2], j[2], 1e-5)
        close(p[3], j[3])
        assert p[4:8] == tuple(j[4:8])
        eq(p[8], j[8])


def test_tutorial_understanding_spcs_smoke():
    """The tutorial's counterpart at its smoke size on the CPU, asserting
    what the JAX tutorial asserts; its octree is the JAX tutorial's."""
    out = load_example("torch_tutorial_understanding_spcs").main("cpu",
                                                                 smoke=True)
    d = np.random.RandomState(0).randn(2000, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    eq(out["octree"], spc_jax.unbatched_points_to_octree(
        spc_jax.quantize_points(jnp.asarray(d * 0.7), 4), 4))
    assert out["dense"].shape == (1, 1, 16, 16, 16)
