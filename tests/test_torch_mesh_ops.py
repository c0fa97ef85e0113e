"""kaolin_tpu_torch's mesh ops (``ops/mesh/{mesh,trianglemesh,tetmesh}.py``,
``ops/batch.py``, ``metrics/trianglemesh.py``) against kaolin_tpu's, on the
CPU.

The same seeded numpy meshes go to both packages. Topology (faces, edges,
the laplacian, subdivided faces, packed metadata, nearest-face ids, distance
types) is equal exactly; float values within 1e-6 absolute and 1e-5
relative (float32, other summation orders), gradients within 1e-5
relative. ``sample_points`` takes a torch Generator where JAX takes a key,
so the test feeds JAX's face choices and barycentric draws to the port
through its two draw functions and compares what it builds from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.metrics import trianglemesh as jmetrics
from kaolin_tpu.ops import batch as jbatch
from kaolin_tpu.ops.mesh import mesh as jmesh
from kaolin_tpu.ops.mesh import tetmesh as jtet
from kaolin_tpu.ops.mesh import trianglemesh as jtri
from kaolin_tpu_torch.metrics import trianglemesh as tmetrics
from kaolin_tpu_torch.ops import batch as tbatch
from kaolin_tpu_torch.ops.mesh import mesh as tmesh
from kaolin_tpu_torch.ops.mesh import tetmesh as ttet
from kaolin_tpu_torch.ops.mesh import trianglemesh as ttri
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _mesh():
    """A 6 x 8 UV sphere (open at its poles, 80 faces), its vertices
    jittered, two copies → (vertices (2, V, 3), faces (F, 3) int64)."""
    v, f = load_example().uv_sphere(6, 8)
    rng = np.random.RandomState(0)
    verts = np.stack([v, v * 1.3]) + rng.uniform(-0.05, 0.05, (2,) + v.shape)
    return verts.astype(np.float32), f.astype(np.int64)


VERTS, FACES = _mesh()
V = VERTS.shape[1]


def tv(x=VERTS, grad=False):
    return torch.tensor(x, requires_grad=grad)


def grad_pair(jax_fn, torch_fn, x, weights_seed=1):
    """Gradients of sum(w · fn(x)) with a seeded w, JAX (jitted) and
    port."""
    out = jax.eval_shape(jax_fn, jax.ShapeDtypeStruct(x.shape, x.dtype))
    w = np.random.RandomState(weights_seed).randn(*out.shape).astype(
        np.float32)
    gj = jax.jit(jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jax_fn(a))))(
        jnp.asarray(x))
    xt = tv(x, grad=True)
    (torch.from_numpy(w) * torch_fn(xt)).sum().backward()
    return xt.grad, gj


# -- ops/mesh/mesh.py --------------------------------------------------------
def test_index_and_unindex_vertices_by_faces():
    close(tmesh.index_vertices_by_faces(tv(), FACES),
          jmesh.index_vertices_by_faces(jnp.asarray(VERTS), FACES))
    close(tmesh.index_vertices_by_faces(tv(), torch.from_numpy(FACES)),
          jmesh.index_vertices_by_faces(jnp.asarray(VERTS), FACES))
    fv = np.array(jmesh.index_vertices_by_faces(jnp.asarray(VERTS), FACES))
    gv, gf = tmesh.unindex_vertices_by_faces(torch.from_numpy(fv))
    wv, wf = jmesh.unindex_vertices_by_faces(jnp.asarray(fv))
    close(gv, wv)
    equal(gf, wf)


@pytest.mark.parametrize("sparse", [False, True])
def test_adjacency_matrix(sparse):
    got = tmesh.adjacency_matrix(V, FACES, sparse=sparse, device="cpu")
    want = jmesh.adjacency_matrix(V, FACES, sparse=sparse)
    if sparse:
        equal(got[0], want[0])
        equal(got[1], want[1])
        assert got[0].dtype == torch.int64
    else:
        equal(got, want)
    assert tmesh.adjacency_matrix(
        V, torch.from_numpy(FACES)).device.type == "cpu"


def test_uniform_laplacian_is_jax_bit_for_bit():
    lap = tmesh.uniform_laplacian(V, FACES, device="cpu")
    equal(lap, jmesh.uniform_laplacian(V, FACES))
    assert lap.dtype == torch.float32
    # an unused vertex keeps a zero row and −1 on the diagonal
    equal(tmesh.uniform_laplacian(V + 2, FACES, device="cpu"),
          jmesh.uniform_laplacian(V + 2, FACES))


def test_average_face_vertex_features_and_vertex_normals():
    rng = np.random.RandomState(2)
    ff = rng.randn(2, FACES.shape[0], 3, 4).astype(np.float32)
    close(tmesh.average_face_vertex_features(FACES, torch.from_numpy(ff)),
          jmesh.average_face_vertex_features(FACES, jnp.asarray(ff)))
    close(tmesh.average_face_vertex_features(FACES, torch.from_numpy(ff),
                                             V + 3),
          jmesh.average_face_vertex_features(FACES, jnp.asarray(ff), V + 3))
    fn = np.asarray(jtri.face_normals(jmesh.index_vertices_by_faces(
        jnp.asarray(VERTS), FACES), unit=True))
    fn3 = np.repeat(fn[:, :, None], 3, axis=2)
    close(tmesh.compute_vertex_normals(FACES, torch.from_numpy(fn3)),
          jmesh.compute_vertex_normals(FACES, jnp.asarray(fn3)))
    g, gj = grad_pair(
        lambda x: jmesh.average_face_vertex_features(FACES, x),
        lambda x: tmesh.average_face_vertex_features(FACES, x), ff)
    close(g, gj)


# -- ops/batch.py ------------------------------------------------------------
ITEMS = [np.random.RandomState(i).randn(n, 3).astype(np.float32)
         for i, n in enumerate((4, 1, 6))]


def test_packed_and_padded_round_trips():
    tl = [torch.from_numpy(x) for x in ITEMS]
    jl = [jnp.asarray(x) for x in ITEMS]
    packed, spt = tbatch.list_to_packed(tl)
    jpacked, jspt = jbatch.list_to_packed(jl)
    close(packed, jpacked)
    equal(spt, jspt)
    fi = tbatch.get_first_idx(spt[:, 0])
    equal(fi, jbatch.get_first_idx(jspt[:, 0]))
    for a, b in zip(tbatch.packed_to_list(packed, spt, fi),
                    jbatch.packed_to_list(jpacked, jspt, fi)):
        close(a, b)
    padded, _ = tbatch.list_to_padded(tl, -1.0)
    jpadded, _ = jbatch.list_to_padded(jl, -1.0)
    close(padded, jpadded)
    close(tbatch.list_to_padded(tl, 0.5, (8,))[0],
          jbatch.list_to_padded(jl, 0.5, (8,))[0])
    for a, b in zip(tbatch.padded_to_list(padded, spt),
                    jbatch.padded_to_list(jpadded, jspt)):
        close(a, b)
    close(tbatch.packed_to_padded(packed, spt, fi, 7.0),
          jbatch.packed_to_padded(jpacked, jspt, fi, 7.0))
    close(tbatch.padded_to_packed(padded, spt),
          jbatch.padded_to_packed(jpadded, jspt))
    close(tbatch.packed_simple_sum(packed, spt[:, 0]),
          jbatch.packed_simple_sum(jpacked, jspt[:, 0]))
    close(tbatch.tile_to_packed(torch.tensor([1.0, 2.0, 3.0]), spt[:, 0]),
          jbatch.tile_to_packed(jnp.asarray([1.0, 2.0, 3.0]), jspt[:, 0]))
    equal(tbatch.packed_segment_ids(spt, total=14, device="cpu"),
          jbatch.packed_segment_ids(jspt, total=14))


def test_rank_two_items_and_max_shapes():
    items = [np.arange(n * m * 2, dtype=np.float32).reshape(n, m, 2)
             for n, m in ((2, 3), (4, 1))]
    tl = [torch.from_numpy(x) for x in items]
    jl = [jnp.asarray(x) for x in items]
    packed, spt = tbatch.list_to_packed(tl)
    jpacked, jspt = jbatch.list_to_packed(jl)
    equal(spt, jspt)
    fi = tbatch.get_first_idx(spt.prod(axis=1))
    close(tbatch.packed_to_padded(packed, spt, fi, -2.0),
          jbatch.packed_to_padded(jpacked, jspt, fi, -2.0))
    padded = tbatch.list_to_padded(tl, 0.0)[0]
    close(tbatch.padded_to_packed(padded, spt),
          jbatch.padded_to_packed(jnp.asarray(padded.numpy()), jspt))
    assert tbatch.fill_max_shape(spt, (None, 5)) == \
        jbatch.fill_max_shape(jspt, (None, 5))
    with pytest.raises(ValueError):
        tbatch.fill_max_shape(spt, (1, None))
    with pytest.raises(ValueError):
        tbatch.get_shape_per_tensor([])


# -- ops/mesh/trianglemesh.py ------------------------------------------------
@pytest.mark.parametrize("unit", [False, True])
def test_face_normals_and_areas(unit):
    fv = np.asarray(jmesh.index_vertices_by_faces(jnp.asarray(VERTS), FACES))
    close(ttri.face_normals(torch.from_numpy(fv), unit=unit),
          jtri.face_normals(jnp.asarray(fv), unit=unit))
    g, gj = grad_pair(lambda x: jtri.face_normals(x, unit=unit),
                      lambda x: ttri.face_normals(x, unit=unit), fv)
    close(g, gj)
    close(ttri.face_areas(tv(), FACES), jtri.face_areas(jnp.asarray(VERTS),
                                                        FACES))


def _packed_mesh():
    v = np.concatenate([VERTS[0], VERTS[1][:30]])
    f2 = FACES[(FACES < 30).all(axis=1)]
    faces = np.concatenate([FACES, f2])
    first_idx = np.array([0, V, V + 30])
    nf = np.array([FACES.shape[0], f2.shape[0]])
    return v, first_idx, faces, nf


def test_packed_face_areas():
    v, fi, faces, nf = _packed_mesh()
    close(ttri.packed_face_areas(torch.from_numpy(v), fi, faces, nf),
          jtri.packed_face_areas(jnp.asarray(v), fi, faces, nf))


def _feed(monkeypatch, choices, w):
    monkeypatch.setattr(ttri, "_choose_faces",
                        lambda gen, areas, n: torch.from_numpy(
                            np.asarray(choices)))
    monkeypatch.setattr(ttri, "_sample_barycentric",
                        lambda gen, shape, dtype, device: tuple(
                            torch.from_numpy(np.asarray(x)) for x in w))


def test_sample_points_from_jax_draws(monkeypatch):
    key = jax.random.PRNGKey(3)
    ff = np.random.RandomState(4).randn(2, FACES.shape[0], 3, 2).astype(
        np.float32)
    pts, choice, feats = jax.jit(lambda v, f, k: jtri.sample_points(
        v, FACES, 50, k, face_features=f))(jnp.asarray(VERTS),
                                           jnp.asarray(ff), key)
    kc, kb = jax.random.split(key)
    w = jax.jit(lambda k: jtri._sample_barycentric(k, (2, 50, 1),
                                                   jnp.float32))(kb)
    _feed(monkeypatch, choice, w)
    gp, gc, gf = ttri.sample_points(tv(), FACES, 50, None,
                                    face_features=torch.from_numpy(ff))
    close(gp, pts)
    equal(gc, choice)
    close(gf, feats)


def test_packed_sample_points_from_jax_draws(monkeypatch):
    v, fi, faces, nf = _packed_mesh()
    key = jax.random.PRNGKey(5)
    pts, merged = jax.jit(lambda x, k: jtri.packed_sample_points(
        x, fi, faces, nf, 40, k))(jnp.asarray(v), key)
    kc, kb = jax.random.split(key)
    choice = np.asarray(merged) - np.array([[0], [nf[0]]])
    w = jax.jit(lambda k: jtri._sample_barycentric(k, (2, 40, 1),
                                                   jnp.float32))(kb)
    _feed(monkeypatch, choice.astype(np.int32), w)
    gp, gm = ttri.packed_sample_points(torch.from_numpy(v), fi, faces, nf,
                                       40, None)
    close(gp, pts)
    equal(gm, merged)


def test_sample_points_own_draws():
    """The port's draws: reproducible from a generator seed, face choices
    never on a zero-area face, every point on its face's plane."""
    faces = np.concatenate([FACES, [[0, 0, 1]]])       # a zero-area face
    verts = tv()
    p1, c1 = ttri.sample_points(verts, faces, 400,
                                torch.Generator().manual_seed(0))
    p2, c2 = ttri.sample_points(verts, faces, 400,
                                torch.Generator().manual_seed(0))
    assert torch.equal(p1, p2) and torch.equal(c1, c2)
    assert c1.dtype == torch.int32 and int(c1.max()) < FACES.shape[0]
    fv = verts[:, torch.from_numpy(faces)]
    sel = torch.take_along_dim(fv, c1.long()[..., None, None], dim=1)
    n = torch.linalg.cross(sel[..., 1, :] - sel[..., 0, :],
                           sel[..., 2, :] - sel[..., 0, :])
    off = ((p1 - sel[..., 0, :]) * n).sum(-1) / n.norm(dim=-1)
    assert float(off.abs().max()) < 1e-5


@pytest.mark.parametrize("iterations,learned", [(1, False), (2, False),
                                                (1, True)])
def test_subdivide_trianglemesh(iterations, learned):
    """Against JAX one mesh at a time where alpha is automatic: JAX's
    version fails at B > 1 then (F18, reference-side; the port does not)."""
    alpha = (np.random.RandomState(6).uniform(0.1, 0.9, (2, V))
             .astype(np.float32) if learned else None)
    gv, gf = ttri.subdivide_trianglemesh(
        tv(), FACES, iterations,
        None if alpha is None else torch.from_numpy(alpha))
    for b in ((0, 1) if alpha is None else (slice(None),)):
        wv, wf = jax.jit(lambda v, a: jtri.subdivide_trianglemesh(
            v, FACES, iterations, a))(
            jnp.asarray(VERTS[b]).reshape(-1, V, 3),
            None if alpha is None else jnp.asarray(alpha))
        close(gv[b].reshape(wv.shape), wv)
        equal(gf, wf)
    g, gj = grad_pair(
        lambda x: jtri.subdivide_trianglemesh(x, FACES, iterations)[0],
        lambda x: ttri.subdivide_trianglemesh(x, FACES, iterations)[0],
        VERTS[:1])
    close(g, gj)


def test_vertex_tangents():
    rng = np.random.RandomState(7)
    fv = np.asarray(jmesh.index_vertices_by_faces(jnp.asarray(VERTS),
                                                  FACES))[0]
    uvs = rng.uniform(0, 1, (FACES.shape[0], 3, 2)).astype(np.float32)
    vn = rng.randn(V, 3).astype(np.float32)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    close(ttri.vertex_tangents(FACES, torch.from_numpy(fv),
                               torch.from_numpy(uvs), torch.from_numpy(vn)),
          jtri.vertex_tangents(FACES, jnp.asarray(fv), jnp.asarray(uvs),
                               jnp.asarray(vn)), atol=1e-5)


def test_uniform_laplacian_smoothing():
    close(ttri.uniform_laplacian_smoothing(tv(), FACES),
          jtri.uniform_laplacian_smoothing(jnp.asarray(VERTS), FACES))
    close(tmetrics.uniform_laplacian_smoothing(tv(), FACES),
          jmetrics.uniform_laplacian_smoothing(jnp.asarray(VERTS), FACES))


# -- ops/mesh/tetmesh.py -----------------------------------------------------
TETS = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
TET_V = np.random.RandomState(8).randn(2, 5, 3).astype(np.float32)


def test_inverse_vertices_offset():
    tv4 = TET_V[:, TETS]
    close(ttet.inverse_vertices_offset(torch.from_numpy(tv4)),
          jtet.inverse_vertices_offset(jnp.asarray(tv4)), atol=1e-5)


@pytest.mark.parametrize("with_features", [False, True])
def test_subdivide_tetmesh(with_features):
    feat = (np.random.RandomState(9).randn(2, 5, 2).astype(np.float32)
            if with_features else None)
    want = jtet.subdivide_tetmesh(jnp.asarray(TET_V), TETS,
                                  None if feat is None else jnp.asarray(feat))
    got = ttet.subdivide_tetmesh(torch.from_numpy(TET_V), TETS,
                                 None if feat is None
                                 else torch.from_numpy(feat))
    assert len(got) == len(want)
    close(got[0], want[0])
    equal(got[1], want[1])
    if with_features:
        close(got[2], want[2])


# -- metrics/trianglemesh.py -------------------------------------------------
def test_point_to_mesh_distance():
    """Distances equal JAX's on points around the mesh and near its
    vertices and edge midpoints, over more faces than one 512-face tile.
    Where the two pick other nearest faces, the faces tie: JAX's distance
    to the port's face equals its own least distance (a closest point on a
    vertex or an edge that several faces share, the region test rounded
    the other way). Elsewhere the ids and distance types are equal, and
    the gradients with respect to the points within 1e-5."""
    rng = np.random.RandomState(10)
    verts, faces = load_example().uv_sphere(12, 24)       # 528 faces
    fv = verts[faces][None].astype(np.float32)
    mids = 0.5 * (verts[faces[:, 0]] + verts[faces[:, 1]])
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (60, 3)), verts[:20] * 1.1,
                          mids[:20] * 0.98]).astype(np.float32)[None]
    d, i, t = tmetrics.point_to_mesh_distance(torch.from_numpy(pts),
                                              torch.from_numpy(fv))
    dj, ij, tj = jmetrics.point_to_mesh_distance(jnp.asarray(pts),
                                                 jnp.asarray(fv))
    close(d, dj)
    same = i.numpy() == np.asarray(ij)
    assert same.mean() > 0.8
    equal(t.numpy()[same], np.asarray(tj)[same])
    other = fv[0][i.numpy()[~same]]
    d_other = jmetrics._closest_on_tri(
        jnp.asarray(pts[~same]), jnp.asarray(other[:, 0]),
        jnp.asarray(other[:, 1]), jnp.asarray(other[:, 2]))[0]
    np.testing.assert_allclose(np.asarray(d_other), np.asarray(dj)[~same],
                               rtol=RTOL, atol=ATOL)
    assert len(set(np.asarray(tj).ravel().tolist())) >= 3
    g, gj = grad_pair(
        lambda x: jmetrics.point_to_mesh_distance(x, jnp.asarray(fv))[0],
        lambda x: tmetrics.point_to_mesh_distance(x, torch.from_numpy(fv))[0],
        pts)
    close(g[0][same[0]], np.asarray(gj)[0][same[0]], atol=1e-5)


def test_average_edge_length():
    close(tmetrics.average_edge_length(tv(), FACES),
          jmetrics.average_edge_length(jnp.asarray(VERTS), FACES))
    g, gj = grad_pair(lambda x: jmetrics.average_edge_length(x, FACES),
                      lambda x: tmetrics.average_edge_length(x, FACES),
                      VERTS)
    close(g, gj)
