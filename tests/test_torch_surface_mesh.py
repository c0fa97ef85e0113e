"""The port's ``SurfaceMesh`` (``kaolin_tpu_torch/rep/surface_mesh.py``)
against kaolin_tpu's, on the CPU.

The same seeded numpy arrays build a mesh in each package. The
auto-computed attributes agree within 1e-6 (every computable attribute by
each of its requirement sets, under the three batchings; the chain of a
UV sphere's normals and tangents; ``face_normals`` by its three routes),
their gradients in the vertices within 1e-5 of max|g|; attribute lists,
strings, batching conversions, ``cat``, ``flatten``, ``__getitem__`` and
``as_transformed`` equal. One departure is held on purpose (ROADMAP Queue
C, F28): after ``mesh.vertices = v2`` every derived attribute of the port's
mesh equals a fresh mesh's, where JAX's keeps its vertex normals, vertex
tangents and face tangents from the old geometry.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.rep import SurfaceMesh as JMesh
from kaolin_tpu_torch.rep import SurfaceMesh as TMesh
from kaolin_tpu_torch.utils import surface_mesh_from_jax
from tests.torch_parity import jax_unoptimized  # noqa: F401
from tests.torch_parity import warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

B = TMesh.Batching
pytestmark = pytest.mark.usefixtures("jax_unoptimized")
ATOL, GRAD_TOL = 1e-6, 1e-5
_REQS = TMesh.computable_attribute_requirements()
_CASES = [(attr, i) for attr, reqs in sorted(_REQS.items())
          for i in range(len(reqs))]


def _full_source(seed=0):
    """``tests/rep/test_surface_mesh_spec.py``'s mesh with every source
    attribute a computable attribute may require, as numpy."""
    rng = np.random.RandomState(seed)
    return dict(
        vertices=np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.],
                           [0., 0., 1.]], np.float32),
        faces=np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]],
                       np.int32),
        normals=rng.randn(5, 3).astype(np.float32),
        face_normals_idx=rng.randint(0, 5, (4, 3)).astype(np.int32),
        uvs=rng.rand(6, 2).astype(np.float32),
        face_uvs_idx=rng.randint(0, 6, (4, 3)).astype(np.int32),
        vertex_colors=rng.rand(4, 3).astype(np.float32),
        vertex_features=rng.rand(4, 7).astype(np.float32),
        face_colors=rng.rand(4, 3, 3).astype(np.float32),
        face_features=rng.rand(4, 3, 7).astype(np.float32))


def uv_sphere(n_lat=6, n_lon=8, seed=0):
    """A UV sphere with per-vertex UVs, its radius jittered by a seed →
    (vertices (V, 3) float32, faces (F, 3) int32, uvs (V, 2) float32)."""
    rng = np.random.RandomState(seed)
    lat = np.linspace(0.3, np.pi - 0.3, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = 1.0 + 0.1 * rng.rand(n_lat, n_lon)
    v = (r[..., None] * np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                                  np.sin(th) * np.sin(ph)], -1)).reshape(-1, 3)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    f = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            f += [[a, b, c], [b, d, c]]
    return (v.astype(np.float32), np.asarray(f, np.int32),
            uv.astype(np.float32))


def pair(batching=B.NONE, **arrays):
    """The same mesh in both packages, from numpy, under ``batching``."""
    return [batched(cls(**{k: conv(np.array(v)) for k, v in arrays.items()}),
                    batching)
            for cls, conv in ((JMesh, jnp.asarray),
                              (TMesh, torch.from_numpy))]


def same(got, want, atol=ATOL):
    """Port value (tensor or list) against JAX's, within ``atol``."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, atol)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _resolve_sources(req, src):
    out = {}
    for r in req:
        if r in src:
            out[r] = src[r]
        else:
            out.update(_resolve_sources(_REQS[r][0], src))
    return out


def auto_compute_case(attr, req_i, batching):
    """The arrays that requirement set ``req_i`` of ``attr`` needs, with
    the vertices and faces."""
    src = _full_source()
    attrs = _resolve_sources(_REQS[attr][req_i], src)
    attrs.setdefault("faces", src["faces"])
    attrs.setdefault("vertices", src["vertices"])
    return attrs


def batched(mesh, batching):
    if batching != B.NONE:
        mesh.to_batched()
        if batching == B.LIST:
            mesh.set_batching(B.LIST)
    return mesh


def jax_auto_compute(attr, req_i, batching):
    """JAX's mesh of the case → (the computed value as numpy, its
    attribute list after)."""
    m = batched(JMesh(**{k: jnp.asarray(v) for k, v in
                         auto_compute_case(attr, req_i, batching).items()}),
                batching)
    val = getattr(m, attr)
    val = ([np.asarray(x) for x in val] if isinstance(val, list)
           else np.asarray(val))
    return val, m.get_attributes()


def jax_vertex_gradient(through):
    """``jax.grad`` of sum(sin(attr)) of a fresh UV-sphere mesh in its
    vertices."""
    v, f, uv = uv_sphere()

    def jloss(x):
        m = JMesh(vertices=x, faces=jnp.asarray(f), uvs=jnp.asarray(uv),
                  face_uvs_idx=jnp.asarray(f))
        return jnp.sum(jnp.sin(getattr(m, through)))

    return np.asarray(jax.grad(jloss)(jnp.asarray(v)))


BATCHINGS = [B.NONE, B.FIXED, B.LIST]
THROUGH = ["face_normals", "vertex_normals", "face_vertices",
           "face_tangents"]


@pytest.fixture(scope="module")
def jax_results():
    """The JAX values of the auto-compute matrix and the vertex
    gradients, computed eagerly in threads at once: each eager op compiles
    on first use, and XLA compiles without the GIL."""
    jobs = {("auto",) + c + (b,): (jax_auto_compute, c + (b,))
            for c in _CASES for b in BATCHINGS}
    jobs.update({("grad", t): (jax_vertex_gradient, (t,)) for t in THROUGH})
    with ThreadPoolExecutor(8) as pool:
        futures = {k: pool.submit(f, *a) for k, (f, a) in jobs.items()}
        return {k: fut.result() for k, fut in futures.items()}


@pytest.mark.parametrize("batching", BATCHINGS)
@pytest.mark.parametrize("attr,req_i", _CASES,
                         ids=[f"{a}-req{i}" for a, i in _CASES])
def test_auto_compute_matches_jax(attr, req_i, batching, jax_results):
    """Every computable attribute from each of its requirement sets, under
    every batching: the value, its shape and its caching, as JAX's."""
    want, want_attrs = jax_results["auto", attr, req_i, batching]
    tm = batched(TMesh(**{k: torch.from_numpy(np.array(v)) for k, v in
                          auto_compute_case(attr, req_i, batching).items()}),
                 batching)
    same(getattr(tm, attr), want)
    assert tm.get_attributes() == want_attrs


@pytest.mark.parametrize("route", ["normals", "vertex_normals", "vertices"])
def test_face_normals_routes_and_chain_match_jax(route):
    """A UV sphere's ``face_normals`` by each route, then the chain through
    ``vertex_normals``, ``vertex_tangents``, ``face_tangents`` and
    ``face_uvs``, within 1e-6 of JAX's."""
    v, f, uv = uv_sphere()
    rng = np.random.RandomState(1)
    extra = {"normals": dict(normals=rng.randn(10, 3).astype(np.float32),
                             face_normals_idx=rng.randint(
                                 0, 10, f.shape).astype(np.int32)),
             "vertex_normals": dict(vertex_normals=rng.randn(
                 *v.shape).astype(np.float32)),
             "vertices": {}}[route]
    jm, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f, **extra)
    for attr in ("face_normals", "vertex_normals", "face_uvs",
                 "vertex_tangents", "face_tangents", "face_vertices"):
        same(getattr(tm, attr), getattr(jm, attr))
    assert tm.get_attributes() == jm.get_attributes()


def test_setting_vertices_refreshes_every_derived_attribute():
    """F28: after ``mesh.vertices = v2`` the port's normals, tangents and
    face values equal a fresh mesh's. JAX drops only what lists
    ``vertices`` directly, so its vertex normals stay the old geometry's
    and its face normals are recomputed from them."""
    v, f, uv = uv_sphere()
    v2 = (v * np.array([1.3, 0.7, 1.1], np.float32)
          + np.float32(0.05) * np.sin(7 * v)).astype(np.float32)
    derived = ("face_vertices", "face_normals", "vertex_normals",
               "vertex_tangents", "face_tangents")
    jm, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    _ = tm.face_tangents, jm.face_tangents
    old_vn = np.asarray(jm.vertex_normals)
    jm.vertices, tm.vertices = jnp.asarray(v2), torch.from_numpy(v2)
    jfresh, tfresh = pair(vertices=v2, faces=f, uvs=uv, face_uvs_idx=f)
    for attr in derived:
        same(getattr(tm, attr), getattr(tfresh, attr).numpy(), atol=0)
        same(getattr(tfresh, attr), getattr(jfresh, attr))
    np.testing.assert_array_equal(np.asarray(jm.vertex_normals), old_vn)
    assert np.abs(old_vn - np.asarray(jfresh.vertex_normals)).max() > 0.05
    for attr in ("face_normals", "vertex_tangents", "face_tangents"):
        assert np.abs(np.asarray(getattr(jm, attr))
                      - np.asarray(getattr(jfresh, attr))).max() > 1e-3


def test_setting_an_attribute_drops_its_dependents_only():
    """Setting ``uvs`` drops what depends on it (face UVs and the
    tangents) and keeps the normals; setting ``face_normals`` keeps it and
    drops the vertex normals and tangents computed from it."""
    v, f, uv = uv_sphere()
    _, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    _ = tm.face_tangents
    tm.uvs = torch.from_numpy(uv[::-1].copy())
    assert tm.get_attributes() == ["vertices", "faces", "face_vertices",
                                   "face_normals", "uvs", "face_uvs_idx",
                                   "vertex_normals"]
    _ = tm.face_tangents
    tm.face_normals = tm.face_normals * -1.0
    assert tm.get_attributes() == ["vertices", "faces", "face_vertices",
                                   "face_normals", "uvs", "face_uvs_idx",
                                   "face_uvs"]


def test_attribute_lists_and_strings_match_jax():
    v, f, uv = uv_sphere()
    jm, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    for name in list(_REQS) + ["vertices", "uvs", "materials"]:
        assert tm.has_attribute(name) == jm.has_attribute(name)
        assert (tm.has_or_can_compute_attribute(name)
                == jm.has_or_can_compute_attribute(name))
    assert tm.to_string() == jm.to_string()
    _ = tm.vertex_tangents, jm.vertex_tangents
    assert tm.get_attributes() == jm.get_attributes()
    assert (tm.to_string(print_stats=True, detailed=True)
            == jm.to_string(print_stats=True, detailed=True))
    assert repr(tm) == repr(jm)
    for batching in B:
        assert (TMesh.attribute_info_string(batching)
                == JMesh.attribute_info_string(batching).replace(
                    "jnp", "torch").replace("array", "tensor"))
    assert (TMesh.supported_tensor_attributes()
            == JMesh.supported_tensor_attributes())
    assert (TMesh.computable_attribute_requirements()
            == JMesh.computable_attribute_requirements())


def test_batching_conversions_match_jax():
    v, f, uv = uv_sphere()
    jm, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    _ = jm.face_normals, tm.face_normals
    for batching in (B.FIXED, B.LIST, B.FIXED, B.NONE, B.LIST, B.NONE):
        for name in ("vertices", "faces", "face_normals"):
            for to in B:
                same(tm.getattr_batched(name, to),
                     jm.getattr_batched(name, to))
        jm.set_batching(batching)
        tm.set_batching(batching)
        assert tm.batching == jm.batching and len(tm) == len(jm)
        assert tm.check_sanity() and jm.check_sanity()
        for name in jm.get_attributes(only_tensors=True):
            same(tm.get_attribute(name), jm.get_attribute(name))
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for frm, to, kw in ((B.NONE, B.FIXED, {}), (B.NONE, B.LIST, {}),
                        (B.NONE, B.FIXED, {"fixed_topology": True}),
                        (B.FIXED, B.LIST, {"fixed_topology": True,
                                           "batch_size": 3})):
        same(TMesh.convert_attribute_batching(torch.from_numpy(x), frm, to,
                                              **kw),
             JMesh.convert_attribute_batching(jnp.asarray(x), frm, to,
                                              **kw))


def test_cat_getitem_flatten_match_jax():
    src = _full_source()
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [5.0, 0.0, -1.0]
    pairs = [pair(vertices=src["vertices"] + k, faces=src["faces"],
                  vertex_colors=src["vertex_colors"]) for k in range(2)]
    jf, tf = pair(vertices=src["vertices"][:3],
                  faces=np.array([[0, 1, 2]], np.int32),
                  vertex_colors=src["vertex_colors"][:3], transform=t)
    for fixed, items in ((True, pairs), (False, pairs + [(jf, tf)])):
        jcat = JMesh.cat([p[0] for p in items], fixed_topology=fixed)
        tcat = TMesh.cat([p[1] for p in items], fixed_topology=fixed)
        assert tcat.batching == jcat.batching and len(tcat) == len(jcat)
        assert sorted(tcat.get_attributes()) == sorted(jcat.get_attributes())
        for name in jcat.get_attributes(only_tensors=True):
            same(tcat.get_attribute(name), jcat.get_attribute(name))
        for i in range(len(jcat)):
            for name in ("vertices", "faces", "face_normals", "face_colors"):
                same(getattr(tcat[i], name), getattr(jcat[i], name))
        with pytest.raises(IndexError):
            tcat[len(jcat)]
    with pytest.raises(ValueError):
        TMesh.cat([pairs[0][1], tf], fixed_topology=True)
    jflat = JMesh.flatten([p[0] for p in pairs] + [jf])
    tflat = TMesh.flatten([p[1] for p in pairs] + [tf])
    assert tflat.get_attributes() == jflat.get_attributes()
    for name in jflat.get_attributes(only_tensors=True):
        same(tflat.get_attribute(name), jflat.get_attribute(name))


@pytest.mark.parametrize("batched", [False, True])
def test_as_transformed_matches_jax(batched):
    """A rotation, an anisotropic scale and a translation, stored or
    given, applied to positions, normals and tangents as JAX applies
    them; (B, 4, 4) over a FIXED batch of two."""
    v, f, uv = uv_sphere()
    c, s = np.cos(0.4), np.sin(0.4)
    m = np.array([[c, 0, s, 0.3], [0, 1.5, 0, -0.2], [-s, 0, c, 0.1],
                  [0, 0, 0, 1]], np.float32)
    jm, tm = pair(vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    _ = jm.face_tangents, tm.face_tangents
    if batched:
        jm = JMesh.cat([jm, jm])
        tm = TMesh.cat([tm, tm])
        m = np.stack([m, np.diag([1.0, 2.0, 0.5, 1.0]).astype(np.float32)])
    for jout, tout in ((jm.as_transformed(jnp.asarray(m)),
                        tm.as_transformed(torch.from_numpy(m))),):
        assert tout.get_attributes() == jout.get_attributes()
        for name in jout.get_attributes(only_tensors=True):
            same(tout.get_attribute(name), jout.get_attribute(name))
    jm.transform, tm.transform = jnp.asarray(m), torch.from_numpy(m)
    jout, tout = jm.as_transformed(), tm.as_transformed()
    assert tout.transform is None and tout.get_attributes() == \
        jout.get_attributes()
    for name in jout.get_attributes(only_tensors=True):
        same(tout.get_attribute(name), jout.get_attribute(name), atol=2e-6)
    _, fresh = pair(vertices=v, faces=f)
    assert fresh.as_transformed() is fresh


def test_get_or_compute_and_ensure_indexed_match_jax():
    src = _full_source()
    jm, tm = pair(vertices=src["vertices"], faces=src["faces"])
    same(tm.get_or_compute_attribute("face_normals", should_cache=False),
         jm.get_or_compute_attribute("face_normals", should_cache=False))
    assert tm.get_attributes() == ["vertices", "faces"]
    fn = np.asarray(jm.get_or_compute_attribute("face_normals"))
    same(tm.get_or_compute_attribute("face_normals"), fn)
    assert tm.get_attributes() == jm.get_attributes()
    jm2, tm2 = pair(vertices=src["vertices"], faces=src["faces"],
                    face_normals=fn)
    for got, want in zip(tm2.ensure_indexed_attribute("normals"),
                         jm2.ensure_indexed_attribute("normals")):
        same(got, want)
    assert tm2.get_attributes() == jm2.get_attributes()
    assert tm2.ensure_indexed_attribute("uvs") == (None, None)
    with pytest.raises(ValueError):
        tm2.ensure_indexed_attribute("vertices")
    assert tm.get_attribute("uvs") is None
    tm.unset_attributes_return_none = False
    with pytest.raises(AttributeError):
        tm.get_attribute("uvs")
    with pytest.raises(AttributeError):
        TMesh.assert_supported("bogus_attr")


@pytest.mark.parametrize("through", THROUGH)
def test_gradients_to_vertices_match_jax(through, jax_results):
    """sum(sin(attr)) of a fresh mesh each call: its gradient in the
    vertices within 1e-5 of max|g| of ``jax.grad``'s."""
    v, f, uv = uv_sphere()
    want = jax_results["grad", through]
    x = torch.from_numpy(v).requires_grad_(True)
    m = TMesh(vertices=x, faces=torch.from_numpy(f), uvs=torch.from_numpy(uv),
              face_uvs_idx=torch.from_numpy(f))
    torch.sum(torch.sin(getattr(m, through))).backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def test_placement_dtypes_and_copies():
    """Tensors keep their dtype and device; arrays go where the vertices
    are; ``to`` moves, ``detach`` detaches, ``float_tensors_to`` casts the
    floats only; a copy shares tensors, a deep copy copies materials."""
    v, f, uv = uv_sphere()
    x = torch.from_numpy(v).requires_grad_(True)
    m = TMesh(vertices=x, faces=torch.from_numpy(f.astype(np.int16)),
              uvs=uv, face_uvs_idx=f, materials=[{"name": "m"}])
    assert m.faces.dtype == torch.int16
    assert m.uvs.dtype == torch.float32 and m.face_uvs_idx.dtype == \
        torch.int32
    assert m.uvs.device == x.device
    same(m.face_vertices, v[f])
    assert m.face_vertices.requires_grad
    c = copy.copy(m)
    assert c.vertices is m.vertices and c.materials is m.materials
    d = copy.deepcopy(m)
    assert d.materials == m.materials and d.materials is not m.materials
    m.to("cpu")
    m.detach()
    assert not m.vertices.requires_grad and not m.face_vertices.requires_grad
    m.float_tensors_to(torch.float64)
    assert m.vertices.dtype == torch.float64
    assert m.faces.dtype == torch.int16
    assert m.as_dict(only_tensors=True).keys() == set(
        m.get_attributes(only_tensors=True))


def test_check_sanity_and_empty_meshes_match_jax():
    src = _full_source()
    jm, tm = pair(vertices=src["vertices"], faces=src["faces"])
    assert tm.check_sanity() and tm.is_triangular()
    jm._attrs["vertex_normals"] = jnp.zeros((7, 3))
    tm._attrs["vertex_normals"] = torch.zeros(7, 3)
    assert tm.check_sanity() == jm.check_sanity() is False
    with pytest.raises(ValueError):
        TMesh(vertices=torch.zeros(4, 3), faces=torch.zeros(2, 3,
                                                            dtype=torch.int32),
              vertex_normals=torch.zeros(9, 3))
    quad = TMesh(vertices=torch.zeros(4, 3),
                 faces=torch.zeros(1, 4, dtype=torch.int32))
    assert not quad.is_triangular()
    for batching in (B.NONE, B.FIXED):
        jm, tm = pair(batching, vertices=src["vertices"][:3],
                      faces=np.zeros((0, 3), np.int32))
        for name in ("face_vertices", "face_normals", "vertex_normals"):
            same(getattr(tm, name), getattr(jm, name))
        assert tm.check_sanity()
    jm, tm = pair(vertices=np.zeros((0, 3), np.float32),
                  faces=np.zeros((0, 3), np.int32))
    same(tm.face_vertices, jm.face_vertices)


def test_surface_mesh_from_jax_carries_every_attribute():
    v, f, uv = uv_sphere()
    jm, _ = pair(B.FIXED, vertices=v, faces=f, uvs=uv, face_uvs_idx=f)
    _ = jm.face_tangents
    tm = surface_mesh_from_jax(jm)
    assert tm.batching == jm.batching
    assert tm.get_attributes() == jm.get_attributes()
    for name in jm.get_attributes(only_tensors=True):
        same(tm.get_attribute(name), jm.get_attribute(name), atol=0)
