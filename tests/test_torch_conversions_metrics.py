"""kaolin_tpu_torch's marching tetrahedra, marching cubes, cubic meshes,
MISE, ``ops/voxelgrid`` and the pointcloud, tetmesh and voxelgrid metrics
against kaolin_tpu's, on the CPU, mirroring ``tests/ops/
test_conversions.py``, ``test_voxelgrid_conversions.py`` and
``tests/metrics/test_pointcloud.py``.

The same numpy inputs go to both packages. Integers (marching-tets and
marching-cubes faces and tet ids, cube-mesh faces, ``sided_distance`` ids,
MISE occupancy, voxel masks, depth maps) are equal; floats within 1e-6
absolute; gradients within 1e-5 of their largest entry. The tetmesh
metrics are held here against kaolin_tpu directly (its own test of them
reads the absent reference checkout), and ``equivolume`` at B > 1 against
a loop of B = 1 calls: kaolin_tpu subtracts every item's mean from every
item there (fault F21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.metrics.pointcloud as pc_jax
import kaolin_tpu.metrics.tetmesh as tm_jax
import kaolin_tpu.metrics.voxelgrid as vgm_jax
import kaolin_tpu.ops.conversions as conv_jax
import kaolin_tpu.ops.voxelgrid as vg_jax
from kaolin_tpu_torch.metrics import pointcloud, tetmesh
from kaolin_tpu_torch.metrics import voxelgrid as vgm
from kaolin_tpu_torch.ops import conversions
from kaolin_tpu_torch.ops import voxelgrid
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

ATOL, GRAD_TOL = 1e-6, 1e-5
DMTET = load_example("torch_tutorial_dmtet")


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def eq(port, want):
    np.testing.assert_array_equal(torch.as_tensor(port).detach().numpy(),
                                  np.asarray(want))


def close(port, want, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def grad_close(port_grad, want_grad):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(port_grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


def tet_case(batch=2, res=4):
    """The tutorial's Kuhn grid at ``res`` with ``batch`` seeded fields
    (a sphere plus noise) and jittered vertices."""
    verts, tets = DMTET.make_tet_grid(res)
    rng = np.random.RandomState(0)
    v = np.stack([verts + rng.uniform(-0.05, 0.05, verts.shape)
                  for _ in range(batch)]).astype(np.float32)
    sdf = np.stack([np.linalg.norm(verts, axis=-1) - 0.6 + 0.2 * rng.randn(
        verts.shape[0]) for _ in range(batch)]).astype(np.float32)
    return v, tets, sdf


# ---- marching tetrahedra ------------------------------------------------
def test_marching_tetrahedra_reference_example():
    vertices = t([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]]).float()
    sdf = t([[-1.0, -1.0, 0.5, 0.5]])
    verts, faces, tet_idx = conversions.marching_tetrahedra(
        vertices, t([[0, 1, 2, 3]]), sdf, True)
    want_v = np.array([[0.0, 0.6667, 0.0], [0.0, 0.0, 0.6667],
                       [0.3333, 0.6667, 0.0], [0.3333, 0.0, 0.6667]])
    close(verts[0], want_v, atol=1e-4)
    eq(faces[0], [[3, 0, 1], [3, 2, 0]])
    eq(tet_idx[0], [0, 0])


@pytest.mark.parametrize("return_tet_idx", [False, True])
def test_marching_tetrahedra_matches_jax(return_tet_idx):
    v, tets, sdf = tet_case()
    want = conv_jax.marching_tetrahedra(jnp.asarray(v), jnp.asarray(tets),
                                        jnp.asarray(sdf), return_tet_idx)
    got = conversions.marching_tetrahedra(t(v), t(tets), t(sdf),
                                          return_tet_idx)
    assert len(got) == len(want) == (3 if return_tet_idx else 2)
    for b in range(v.shape[0]):
        assert got[1][b].shape[0] > 0
        close(got[0][b], want[0][b])
        eq(got[1][b], want[1][b])
        if return_tet_idx:
            eq(got[2][b], want[2][b])


def test_marching_tetrahedra_is_differentiable():
    """The port's eager API has gradients in the vertices and the SDF; they
    equal JAX's through ``marching_tetrahedra_fixed``, whose active slots
    are the eager vertices in the same order. kaolin_tpu's eager API reads
    the SDF with ``np.asarray`` and cannot be differentiated (fault F23)."""
    v, tets, sdf = tet_case(batch=1)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.grad(lambda s: jnp.sum(conv_jax.marching_tetrahedra(
            jnp.asarray(v), jnp.asarray(tets), s)[0][0]))(jnp.asarray(sdf))
    v, sdf = v[0], sdf[0]
    mask = np.asarray(conversions.marching_tetrahedra_fixed(
        t(v), t(tets), t(sdf))["vert_mask"])
    w = np.random.RandomState(1).randn(int(mask.sum()), 3).astype(np.float32)
    w_full = np.zeros((mask.shape[0], 3), np.float32)
    w_full[mask] = w

    def jax_loss(vv, s):
        return jnp.sum(conv_jax.marching_tetrahedra_fixed(
            vv, tets, s)["verts"] * w_full)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(v),
                                                       jnp.asarray(sdf))
    args = [t(v).requires_grad_(True), t(sdf).requires_grad_(True)]
    out = conversions.marching_tetrahedra(args[0][None], t(tets),
                                          args[1][None])[0][0]
    (out * t(w)).sum().backward()
    for a, g in zip(args, want):
        grad_close(a.grad, g)


def test_marching_tetrahedra_fixed_matches_jax():
    """Every slot: vertices, masks, faces (edge ids) and tet ids; the
    gradient through the vertex slots."""
    v, tets, sdf = tet_case(batch=1)
    v, sdf = v[0], sdf[0]
    want = jax.jit(lambda vv, s: conv_jax.marching_tetrahedra_fixed(
        vv, tets, s))(jnp.asarray(v), jnp.asarray(sdf))
    got = conversions.marching_tetrahedra_fixed(t(v), t(tets), t(sdf))
    assert sorted(got) == sorted(want)
    close(got["verts"][got["vert_mask"]],
          np.asarray(want["verts"])[np.asarray(want["vert_mask"])])
    for k in ("vert_mask", "faces", "face_mask", "tet_idx"):
        eq(got[k], want[k])
    eager = conversions.marching_tetrahedra(t(v)[None], t(tets),
                                            t(sdf)[None])[0][0]
    assert eager.shape[0] == int(got["vert_mask"].sum())

    mask = np.asarray(want["vert_mask"])
    w = np.random.RandomState(2).randn(*want["verts"].shape).astype(
        np.float32) * mask[:, None]

    def jax_loss(vv, s):
        return jnp.sum(conv_jax.marching_tetrahedra_fixed(
            vv, tets, s)["verts"] * w)

    g_want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(v),
                                                         jnp.asarray(sdf))
    args = [t(v).requires_grad_(True), t(sdf).requires_grad_(True)]
    (conversions.marching_tetrahedra_fixed(args[0], t(tets), args[1])[
        "verts"] * t(w)).sum().backward()
    for a, g in zip(args, g_want):
        grad_close(a.grad, g)


# ---- point-cloud metrics ------------------------------------------------
@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(0)
    p1 = rng.randn(2, 300, 3).astype(np.float32)
    p2 = rng.randn(2, 2600, 3).astype(np.float32)   # two tiles of 2,048
    return p1, p2


def test_sided_distance_matches_jax(clouds):
    p1, p2 = clouds
    want_d, want_i = pc_jax.sided_distance(jnp.asarray(p1), jnp.asarray(p2))
    got_d, got_i = pointcloud.sided_distance(t(p1), t(p2))
    eq(got_i, want_i)
    close(got_d, want_d)
    naive = ((p1[:, :, None] - p2[:, None]) ** 2).sum(-1).argmin(-1)
    eq(got_i, naive)


def test_sided_distance_ties_take_the_first():
    """Equal candidates in one tile and across tiles: the lowest index."""
    p1 = np.zeros((1, 2, 3), np.float32)
    p1[0, 1] = [1.0, 0.0, 0.0]
    p2 = np.ones((1, 4200, 3), np.float32) * 5
    for j in (7, 2100, 4100):
        p2[0, j] = [0.0, 0.0, 1.0]
        p2[0, j + 1] = [1.0, 0.0, 1.0]
    want = pc_jax.sided_distance(jnp.asarray(p1), jnp.asarray(p2))[1]
    got = pointcloud.sided_distance(t(p1), t(p2))[1]
    eq(got, want)
    eq(got, [[7, 8]])


def test_chamfer_and_f_score_match_jax(clouds):
    p1, p2 = clouds
    p2 = p2[:, :500]
    for squared in (True, False):
        want = pc_jax.chamfer_distance(jnp.asarray(p1), jnp.asarray(p2),
                                       w1=0.7, w2=1.3, squared=squared)
        got = pointcloud.chamfer_distance(t(p1), t(p2), w1=0.7, w2=1.3,
                                          squared=squared)
        close(got, want)
    for radius in (0.1, 0.3):
        want = pc_jax.f_score(jnp.asarray(p1), jnp.asarray(p2), radius)
        close(pointcloud.f_score(t(p1), t(p2), radius), want)


def test_chamfer_gradients_match_jax(clouds):
    p1, p2 = clouds
    p2 = p2[:, :500]

    def jax_loss(a, b):
        return jnp.sum(pc_jax.chamfer_distance(a, b))

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(p1),
                                              jnp.asarray(p2))
    args = [t(p1).requires_grad_(True), t(p2).requires_grad_(True)]
    pointcloud.chamfer_distance(*args).sum().backward()
    for a, g in zip(args, want):
        grad_close(a.grad, g)


# ---- tetmesh metrics ----------------------------------------------------
def tets_batch(b, n=20, seed=0):
    """Regular tets, jittered by up to 0.15 of their edge, moved and
    scaled: AMIPS's measure is for tets near their rest shape (on
    near-flat random tets its cube root of det² turns a float32 ulp of the
    determinant into 1e-6 of the mean)."""
    rng = np.random.RandomState(seed)
    rest = np.array([[0.0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                     [0.5, np.sqrt(3) / 6, np.sqrt(2 / 3)]])
    tv = (rest + rng.uniform(-0.15, 0.15, (b, n, 4, 3))) \
        * rng.uniform(0.5, 2.0, (b, n, 1, 1)) + rng.randn(b, n, 1, 3)
    return tv.astype(np.float32)


def test_tetrahedron_volume_and_amips_match_jax():
    tv = tets_batch(2)
    close(tetmesh.tetrahedron_volume(t(tv)),
          tm_jax.tetrahedron_volume(jnp.asarray(tv)))
    inv = np.linalg.inv(np.array([[1.0, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                                  [0.5, np.sqrt(3) / 6, np.sqrt(2 / 3)]])
                        ).astype(np.float32)
    want = tm_jax.amips(jnp.asarray(tv), jnp.asarray(inv))
    got = tetmesh.amips(t(tv), t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    flipped = tv[:, :, [1, 0, 2, 3]]             # negative determinants
    close(tetmesh.amips(t(flipped), t(inv)),
          tm_jax.amips(jnp.asarray(flipped), jnp.asarray(inv)))
    with pytest.raises(ValueError):
        tetmesh.tetrahedron_volume(t(tv[0]))


def test_equivolume_matches_jax_at_one_item():
    tv = tets_batch(1)
    for pow_ in (2, 4):
        close(tetmesh.equivolume(t(tv), pow=pow_),
              tm_jax.equivolume(jnp.asarray(tv), pow=pow_))
    close(tetmesh.equivolume(t(tv), tetrahedrons_mean=t([0.05])),
          tm_jax.equivolume(jnp.asarray(tv),
                            tetrahedrons_mean=jnp.asarray([0.05])))


@pytest.mark.parametrize("num_tets", [5, 2])
def test_equivolume_uses_each_items_mean(num_tets):
    """F21: at B = 2 the port equals B = 1 calls item by item. kaolin_tpu
    raises where T != B and, where T = B, subtracts the other item's mean
    too."""
    tv = tets_batch(2, n=num_tets, seed=3)
    got = tetmesh.equivolume(t(tv))
    loop = torch.cat([tetmesh.equivolume(t(tv[b:b + 1])) for b in range(2)])
    close(got, loop.numpy(), atol=0)
    assert got.shape == (2, 1)
    if num_tets != 2:
        with pytest.raises(TypeError, match="broadcast"):
            tm_jax.equivolume(jnp.asarray(tv))
    else:
        jax_b = np.asarray(tm_jax.equivolume(jnp.asarray(tv)))
        assert not np.allclose(jax_b, loop.numpy())


# ---- voxelgrid conversions ------------------------------------------------
def blob_grids(n=10, seed=0):
    """Two voxelgrids: a noisy ball (binary) and a radial float field."""
    rng = np.random.RandomState(seed)
    c = (n - 1) / 2
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    r = np.linalg.norm(ijk - c, axis=-1)
    ball = ((r + rng.randn(n, n, n)) < 3.5).astype(np.float32)
    radial = np.clip(1.0 - r / c, 0, None).astype(np.float32)
    return np.stack([ball, radial])


@pytest.mark.parametrize("iso", [0.5, 0.2])
def test_marching_cubes_matches_jax(iso):
    vg = blob_grids()
    wv, wf = conv_jax.voxelgrids_to_trianglemeshes(jnp.asarray(vg), iso)
    gv, gf = conversions.voxelgrids_to_trianglemeshes(t(vg), iso)
    for b in range(2):
        assert gf[b].shape[0] > 0
        close(gv[b], wv[b], atol=0)
        eq(gf[b], wf[b])
    empty = conversions.voxelgrids_to_trianglemeshes(torch.zeros(1, 3, 3, 3))
    assert empty[0][0].shape == (0, 3) and empty[1][0].shape == (0, 3)


@pytest.mark.parametrize("is_trimesh", [True, False])
def test_cubic_meshes_match_jax(is_trimesh):
    vg = blob_grids()[:1]
    vg = np.concatenate([vg, np.zeros_like(vg)])
    wv, wf = conv_jax.voxelgrids_to_cubic_meshes(jnp.asarray(vg), is_trimesh)
    gv, gf = conversions.voxelgrids_to_cubic_meshes(t(vg), is_trimesh)
    for b in range(2):
        close(gv[b], wv[b], atol=0)
        eq(gf[b], wf[b])
        assert gf[b].shape == np.asarray(wf[b]).shape


def test_sdf_to_voxelgrids_matches_jax():
    """MISE occupancy equal to JAX's, and to the dense evaluation."""
    def jblob(p):
        return jnp.sqrt(jnp.sum((p - jnp.asarray([0.05, 0.0, -0.1])) ** 2,
                                1)) - 0.3

    def tblob(p):
        return torch.sqrt(((p - torch.tensor([0.05, 0.0, -0.1])) ** 2).sum(
            1)) - 0.3

    def tsphere(p):
        return (p ** 2).sum(1) ** 0.5 - 0.5

    def jsphere(p):
        return jnp.sum(p ** 2, 1) ** 0.5 - 0.5

    for kw in (dict(init_res=4, upsampling_steps=2),
               dict(init_res=4, upsampling_steps=0),
               dict(init_res=8, upsampling_steps=1, bbox_center=0.1,
                    bbox_dim=1.2)):
        want = conv_jax.sdf_to_voxelgrids([jblob, jsphere], **kw)
        got = conversions.sdf_to_voxelgrids([tblob, tsphere], device="cpu",
                                            **kw)
        eq(got, want)
    dense = conversions.sdf_to_voxelgrids([tblob], init_res=16,
                                          device="cpu")
    eq(conversions.sdf_to_voxelgrids([tblob], init_res=4,
                                     upsampling_steps=2, device="cpu"), dense)
    with pytest.raises(TypeError):
        conversions.sdf_to_voxelgrids(tblob, device="cpu")


def test_sdf_to_voxelgrids_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conversions.sdf_to_voxelgrids([lambda p: p[:, 0]])


# ---- ops/voxelgrid and metrics/voxelgrid ----------------------------------
def test_downsample_and_extract_surface_match_jax():
    vg = blob_grids(12)
    for scale in (2, [2, 3, 4], 1):
        close(voxelgrid.downsample(t(vg), scale),
              vg_jax.downsample(jnp.asarray(vg), scale))
    binary = vg[:1] > 0.5
    for mode in ("wide", "thin"):
        eq(voxelgrid.extract_surface(t(binary), mode),
           vg_jax.extract_surface(jnp.asarray(binary), mode))
    with pytest.raises(ValueError):
        voxelgrid.extract_surface(t(binary), "other")
    with pytest.raises(ValueError):
        voxelgrid.downsample(t(vg), 20)


def test_fill_matches_jax():
    """A hollow shell with a hole-free inside, a cup open to the outside
    and a random grid."""
    shell = np.zeros((1, 8, 8, 8), bool)
    shell[0, 1:7, 1:7, 1:7] = True
    shell[0, 2:6, 2:6, 2:6] = False
    cup = shell.copy()
    cup[0, 3:5, 3:5, 6] = False
    rnd = np.random.RandomState(4).rand(1, 8, 8, 8) > 0.55
    vg = np.concatenate([shell, cup, rnd])
    got = voxelgrid.fill(t(vg))
    eq(got, vg_jax.fill(jnp.asarray(vg)))
    assert bool(got[0, 3, 3, 3]) and not bool(got[1, 3, 3, 3])


def test_odms_and_iou_match_jax():
    vg = blob_grids(9)[:1] > 0.5
    vg = np.concatenate([vg, np.random.RandomState(5).rand(1, 9, 9, 9) > 0.6])
    odms = voxelgrid.extract_odms(t(vg))
    eq(odms, vg_jax.extract_odms(jnp.asarray(vg)))
    for votes in (1, 3):
        eq(voxelgrid.project_odms(odms, votes=votes),
           vg_jax.project_odms(jnp.asarray(odms.numpy()), votes=votes))
        eq(voxelgrid.project_odms(odms, t(vg), votes),
           vg_jax.project_odms(jnp.asarray(odms.numpy()), jnp.asarray(vg),
                               votes))
    other = np.roll(vg, 1, axis=1)
    close(vgm.iou(t(vg), t(other)), vgm_jax.iou(jnp.asarray(vg),
                                                jnp.asarray(other)))
