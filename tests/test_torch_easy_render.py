"""The port's ``easy_render``, DefTet and nvdiffrast stubs against
kaolin_tpu's, on the CPU; the port's images against the repo's goldens.

``render_mesh`` on ``tests/render/golden_corpus.py``'s four easy-render
scenes at 128² (ortho, SG diffuse, textured, a second camera) and on
``examples/torch_easy_render.py``'s two-material scene at 64², each scene
built from the same numpy arrays in both packages: ``face_idx`` equal and
every pass within 1e-5 of its max|x| (the textured scene's albedo
against JAX's sampling at the port's UVs). The port's images against the
goldens at the corpus's thresholds (0.1 / 1%), ``sh9_diffuse`` and
``deftet_uv`` included. The gradient of sum(render²) at 32², through a
fresh mesh each call, in the vertices, the diffuse texture and the light,
within 1e-4 of max|g| of ``jax.grad``'s. DefTet's ``face_idx`` equal to
JAX's on its dense and streamed routes with ties on shared edges, its
features within 1e-6 and its gradients within 1e-5 of max|g|.

The JAX renders are jitted once a scene, with XLA's optimizations off so
that no product is contracted into a fused multiply-add: the winner search
then sees JAX's eager barycentrics. A module fixture computes every JAX
result at once, in threads.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.render.easy_render as je
from kaolin_tpu.render.camera import Camera as JCamera
from kaolin_tpu.render.materials import PBRMaterial as JMaterial
from kaolin_tpu.render.mesh import deftet_sparse_render as jdeftet
from kaolin_tpu.render.mesh import utils as jutils
from kaolin_tpu.rep import SurfaceMesh as JMesh
from kaolin_tpu.utils.testing import assert_images_close
from kaolin_tpu_torch.ops.mesh import (
    compute_vertex_normals,
    face_normals,
    index_vertices_by_faces,
)
from kaolin_tpu_torch.render import easy_render as te
from kaolin_tpu_torch.render.camera import Camera as TCamera
from kaolin_tpu_torch.render.lighting import sh9_diffuse
from kaolin_tpu_torch.render.materials import PBRMaterial as TMaterial
from kaolin_tpu_torch.render.mesh import (
    default_nvdiffrast_context,
    nvdiffrast_is_available,
    rasterize,
)
from kaolin_tpu_torch.render.mesh import deftet_sparse_render as tdeftet
from kaolin_tpu_torch.render.mesh import nvdiffrast_context
from kaolin_tpu_torch.rep import SurfaceMesh as TMesh
from kaolin_tpu_torch.utils import pbr_material_from_jax
from tests.render.golden_corpus import GOLDEN_DIR
from tests.torch_parity import (  # noqa: F401
    grid_faces,
    jax_unoptimized,
    jax_without_contraction,
    load_example,
    torch_threads_per_worker,
    warm_torch_exp,
)

pytestmark = pytest.mark.usefixtures("jax_unoptimized")
PASS_TOL, FEAT_TOL, GRAD_TOL, RENDER_GRAD_TOL = 1e-5, 1e-6, 1e-5, 1e-4
GOLDEN_RES = 128
EX = load_example("torch_easy_render")


def sphere(n_lat=24, n_lon=32):
    """``golden_corpus._sphere_mesh`` as numpy."""
    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    f = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            f += [[a, b, c], [b, d, c]]
    return v.astype(np.float32), np.asarray(f, np.int32)


def textured_arrays():
    """``golden_corpus.render_textured_easy``'s UVs and (64, 64, 3)
    checker, as numpy."""
    v, _ = sphere()
    th = np.arctan2(v[:, 2], v[:, 0])
    ph = np.arccos(np.clip(v[:, 1], -1, 1))
    uvs = np.stack([th / (2 * np.pi) + 0.5, ph / np.pi], -1).astype(
        np.float32)
    ij = np.indices((64, 64)).sum(axis=0)
    checker = np.where((ij // 8) % 2 == 0, 0.85, 0.2).astype(np.float32)
    return uvs, np.stack([checker, 0.5 * checker, 1.0 - checker], -1)


# scene → (camera arguments, which arrays the mesh carries, pass golden)
CAMERAS = {
    "corpus": dict(eye=[1.6, 1.2, 1.8], at=[0.0, 0.0, 0.0], fov=0.8),
    "ortho": dict(eye=[1.5, 1.0, 1.5], at=[0.0, 0.0, 0.0],
                  fov_distance=1.2),
    "cam2": dict(eye=[-1.2, 1.8, 0.7], at=[0.0, 0.1, 0.0], fov=0.5),
}
SCENES = {
    "ortho_easy_render": ("ortho", "plain", "render"),
    "sg_diffuse": ("corpus", "plain", "diffuse"),
    "textured_easy_render": ("corpus", "textured", "render"),
    "easy_render_cam2": ("cam2", "plain", "render"),
}


def camera(pkg, which, res):
    """The camera ``which`` of ``CAMERAS`` in one package."""
    kw = dict(CAMERAS[which])
    if pkg == "jax":
        kw = {k: (jnp.asarray(v) if isinstance(v, list) else v)
              for k, v in kw.items()}
        return JCamera.from_args(up=jnp.asarray([0., 1., 0.]), width=res,
                                 height=res, **kw)
    kw = {k: (torch.tensor(v) if isinstance(v, list) else v)
          for k, v in kw.items()}
    return TCamera.from_args(up=torch.tensor([0., 1., 0.]), width=res,
                             height=res, device="cpu", **kw)


def scene_arrays(kind):
    v, f = sphere()
    out = {"vertices": v * np.float32(0.6), "faces": f}
    if kind == "textured":
        uvs, tex = textured_arrays()
        out.update(uvs=uvs, face_uvs_idx=f,
                   material_assignments=np.zeros(len(f), np.int16))
        out["texture"] = tex
    return out


def mesh_of(pkg, arrays, vertices=None):
    """A mesh of ``arrays`` in the JAX package or the port, its vertices
    replaced by ``vertices`` when given (a traced array or a tensor)."""
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy

    def conv(a, f=conv):
        return f(np.array(a)) if isinstance(a, np.ndarray) else a

    kw = {k: conv(a) for k, a in arrays.items()
          if k not in ("texture", "materials")}
    if vertices is not None:
        kw["vertices"] = vertices
    if "texture" in arrays:
        mat = (JMaterial if pkg == "jax" else TMaterial)(
            diffuse_texture=conv(arrays["texture"]), material_name="checker")
        kw["materials"] = [mat]
    if "materials" in arrays:
        kw["materials"] = arrays["materials"][pkg]
    return (JMesh if pkg == "jax" else TMesh)(**kw)


def two_material_arrays(res):
    """The example's scene at 16 x 24 with 64² textures: numpy arrays and
    both packages' materials (from the same arrays)."""
    a = EX.scene_arrays(16, 24, 64)
    jmats = [JMaterial(material_name="checker", is_specular_workflow=True,
                       diffuse_texture=jnp.asarray(a["checker"]),
                       normals_texture=jnp.asarray(a["bump"]),
                       specular_color=jnp.full(3, 0.2),
                       roughness_value=0.35),
             JMaterial(material_name="metal",
                       diffuse_color=jnp.asarray(EX.METAL_COLOR),
                       metallic_value=0.7,
                       roughness_texture=jnp.asarray(a["roughness"]))]
    return {"vertices": a["vertices"], "faces": a["faces"],
            "vertex_features": a["vertex_features"],
            "face_uvs": a["face_uvs"],
            "material_assignments": a["material_assignments"],
            "materials": {"jax": jmats, "torch": [pbr_material_from_jax(m)
                                                  for m in jmats]}}


def jax_passes(cam_which, arrays, res):
    """JAX's render of the scene, jitted once, with XLA's optimizations
    off → dict of numpy passes."""
    # concrete arrays, made before the trace: the mesh reads its faces on
    # the host
    arrays = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
              for k, a in arrays.items()}

    def run(v):
        return je.render_mesh(camera("jax", cam_which, res),
                              mesh_of("jax", arrays, v),
                              lighting=je.default_lighting())

    with jax_without_contraction():
        out = jax.jit(run)(jnp.asarray(arrays["vertices"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX result the module compares against, computed in threads
    at once (XLA compiles without the GIL): the corpus scenes' and the
    two-material scene's passes, the render's gradient and DefTet's two
    routes."""
    jobs = {("corpus", name): (jax_passes, (cam, scene_arrays(kind),
                                            GOLDEN_RES))
            for name, (cam, kind, _) in SCENES.items()}
    jobs["two"] = (jax_passes, ("corpus", two_material_arrays(64), 64))
    jobs["grad"] = (jax_render_gradient, ())
    jobs.update({("deftet", c): (jax_deftet, (c,)) for c in DEFTET_CHUNKS})
    with jax_without_contraction(), ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(f, *a) for k, (f, a) in jobs.items()}
        return {k: fut.result() for k, fut in futures.items()}


@pytest.fixture(scope="module")
def corpus_renders(jax_refs):
    """Each corpus scene rendered by both packages at 128²."""
    out = {}
    for name, (cam, kind, _) in SCENES.items():
        got = te.render_mesh(camera("torch", cam, GOLDEN_RES),
                             mesh_of("torch", scene_arrays(kind)),
                             lighting=te.default_lighting("cpu"))
        out[name] = (got, jax_refs["corpus", name])
    return out


def same_passes(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["face_idx"].numpy(), want["face_idx"])
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                   atol=PASS_TOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_corpus_render_matches_jax(name, corpus_renders):
    """Every pass within 1e-5 of its max|x|. The textured scene's albedo
    is held in two steps: the UVs as the other passes, and the albedo
    against JAX's ``texture_mapping`` at the port's UVs. Its texture is
    read with 64 texel rows a unit of v and a contrast of 0.65, which
    turns the UVs' float32 rounding into up to 2.1e-5 between JAX's own
    eager and jitted renders."""
    got, want = corpus_renders[name]
    if name == "textured_easy_render":
        want = dict(want)
        want_albedo = want.pop("albedo")
        uvs = got["uvs"].numpy()
        sampled = np.asarray(jutils.texture_mapping(
            jnp.asarray(uvs), jnp.asarray(scene_arrays("textured")[
                "texture"])[None], mode="bilinear"))[..., :3]
        covered = (want["face_idx"] >= 0)[..., None]
        np.testing.assert_allclose(
            got["albedo"].numpy(), np.where(covered, sampled, 0.0), rtol=0,
            atol=PASS_TOL)
        np.testing.assert_array_equal(got["albedo"].numpy() == 0,
                                      want_albedo == 0)
        got = {k: v for k, v in got.items() if k != "albedo"}
    same_passes(got, want)


def _golden(name):
    from PIL import Image
    return np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")),
                      dtype=np.float32) / 255.0


def _close_to_golden(name, img):
    img = np.clip(img, 0.0, 1.0)
    if img.shape[-1] == 2:
        img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
    assert_images_close(_golden(name), img, pixel_disagreement_threshold=0.1,
                        max_percent_disagreeing_pixels=1.0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_corpus_render_matches_golden(name, corpus_renders):
    _close_to_golden(name, corpus_renders[name][0][SCENES[name][2]][0]
                     .numpy())


def _project(cam, verts, faces):
    vc = cam.extrinsics.transform(verts[None])
    vi = cam.intrinsics.transform(vc)[..., :2]
    return (index_vertices_by_faces(vc, faces)[..., 2],
            index_vertices_by_faces(vi, faces))


def test_sh9_diffuse_matches_golden():
    """``golden_corpus.render_sh9_diffuse`` through the port."""
    v, f = sphere()
    verts, faces = torch.from_numpy(v), torch.from_numpy(f)
    cam = camera("torch", "corpus", GOLDEN_RES)
    fn_w = face_normals(index_vertices_by_faces(verts[None], faces),
                        unit=True)
    fn_pc = fn_w[:, :, None, :].expand(-1, -1, 3, -1)
    vn = compute_vertex_normals(faces, fn_pc, num_vertices=len(v))[0]
    fvz, fvi = _project(cam, verts * 0.6, faces)
    img, _ = rasterize(GOLDEN_RES, GOLDEN_RES, fvz, fvi,
                       index_vertices_by_faces(vn[None], faces))
    normals = img.reshape(-1, 3)
    normals = normals / torch.linalg.vector_norm(
        normals, dim=-1, keepdim=True).clamp(min=1e-6)
    shaded = sh9_diffuse([0.5, 0.7, 0.5], normals,
                         torch.tensor([[1.0, 0.9, 0.7]]))
    _close_to_golden("sh9_diffuse",
                     shaded.reshape(GOLDEN_RES, GOLDEN_RES, 3).numpy())


def deftet_uv_inputs(pkg, res):
    """``golden_corpus.render_deftet_uv``'s inputs in one package."""
    v, f = sphere()
    cam = camera(pkg, "corpus", res)
    if pkg == "jax":
        verts, faces, xp = jnp.asarray(v), jnp.asarray(f), jnp
    else:
        verts, faces, xp = torch.from_numpy(v), torch.from_numpy(f), torch
    vc = cam.extrinsics.transform(verts[None])
    vi = cam.intrinsics.transform(vc)[..., :2]
    idx = (__import__("kaolin_tpu.ops.mesh", fromlist=["x"])
           .index_vertices_by_faces if pkg == "jax"
           else index_vertices_by_faces)
    fvz = idx(vc, faces)[..., 2]
    fvi = idx(vi, faces)
    fuv = idx(((verts[:, :2] + 1.0) * 0.5)[None], faces)
    xs = xp.linspace(-1.0, 1.0, res)
    px, py = xp.meshgrid(xs, xs, indexing="xy")
    pixel_coords = xp.stack([px.reshape(-1), py.reshape(-1)], -1)[None]
    near = float(fvz.min())
    ranges = (jnp.broadcast_to(jnp.asarray([near, 0.0]), (1, res * res, 2))
              if pkg == "jax" else
              torch.tensor([near, 0.0]).expand(1, res * res, 2))
    return pixel_coords, ranges, fvz, fvi, fuv


def test_deftet_uv_matches_golden():
    pc, ranges, fvz, fvi, fuv = deftet_uv_inputs("torch", GOLDEN_RES)
    feats, face_idx = tdeftet(pc, ranges, fvz, fvi, fuv, knum=6)
    img = torch.where((face_idx[:, :, 0] >= 0)[..., None], feats[:, :, 0],
                      0.0)
    _close_to_golden("deftet_uv",
                     img.reshape(GOLDEN_RES, GOLDEN_RES, 2).numpy())


@pytest.fixture(scope="module")
def two_material(jax_refs):
    """The two-material scene rendered by both packages at 64²."""
    arrays = two_material_arrays(64)
    want = jax_refs["two"]
    got = te.render_mesh(camera("torch", "corpus", 64),
                         mesh_of("torch", arrays),
                         lighting=te.default_lighting("cpu"))
    return arrays, got, want


def test_two_material_render_matches_jax(two_material):
    """Both workflows, the normal map through the tangent chain, the
    roughness texture and value, the metallic value: every pass."""
    arrays, got, want = two_material
    same_passes(got, want)
    covered = got["face_idx"] >= 0
    ids = torch.from_numpy(arrays["material_assignments"]).long()[
        got["face_idx"].clamp(min=0).long()]
    assert bool((covered & (ids == 0)).any() and (covered & (ids == 1)).any())


def gradient_start(arrays):
    """The gradient test's point: the scene's vertices, material 0's
    diffuse texture and ``default_lighting()``'s lobe, as numpy."""
    light = je.default_lighting()
    return {"vertices": arrays["vertices"],
            "texture": np.asarray(arrays["materials"]["jax"][0]
                                  .diffuse_texture),
            "amplitude": np.asarray(light.amplitude),
            "direction": np.asarray(light.direction),
            "sharpness": np.asarray(light.sharpness)}


def jax_render_gradient(res=32):
    """``jax.grad`` of sum(render²) at ``gradient_start``, through a fresh
    mesh each call, jitted with nothing contracted → {name: numpy}."""
    arrays = two_material_arrays(res)
    mats = arrays["materials"]["jax"]
    jarrays = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
               for k, a in arrays.items()}

    def jloss(p):
        m0 = JMaterial(material_name="checker", is_specular_workflow=True,
                       diffuse_texture=p["texture"],
                       normals_texture=mats[0].normals_texture,
                       specular_color=mats[0].specular_color,
                       roughness_value=mats[0].roughness_value)
        mesh = mesh_of("jax", {**jarrays,
                               "materials": {"jax": [m0, mats[1]]}},
                       p["vertices"])
        lighting = je.default_lighting()
        lighting.amplitude, lighting.direction, lighting.sharpness = (
            p["amplitude"], p["direction"], p["sharpness"])
        out = je.render_mesh(camera("jax", "corpus", res), mesh,
                             lighting=lighting)
        return jnp.sum(out["render"] ** 2)

    with jax_without_contraction():
        want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in
                                         gradient_start(arrays).items()})
    return {k: np.asarray(v) for k, v in want.items()}


def test_render_gradients_match_jax(jax_refs):
    """sum(render²) at 32² through a fresh mesh each call: the gradient
    in the vertices, material 0's diffuse texture and the light's
    amplitude, direction and sharpness within 1e-4 of max|g|."""
    res = 32
    arrays = two_material_arrays(res)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in gradient_start(arrays).items()}
    mats = arrays["materials"]["torch"]
    mats[0].diffuse_texture = p["texture"]
    mesh = mesh_of("torch", arrays, p["vertices"])
    lighting = te.default_lighting("cpu")
    lighting.amplitude, lighting.direction, lighting.sharpness = (
        p["amplitude"], p["direction"], p["sharpness"])
    out = te.render_mesh(camera("torch", "corpus", res), mesh,
                         lighting=lighting)
    torch.sum(out["render"] ** 2).backward()
    for k, w in jax_refs["grad"].items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(p[k].grad.numpy(), w, rtol=0, err_msg=k,
                                   atol=RENDER_GRAD_TOL * np.abs(w).max())


def test_fit_step_on_the_cpu_lowers_the_loss():
    """The example's fit at 24² for 4 steps on the CPU: finite losses,
    falling; each step sets ``mesh.vertices`` and the tangents follow."""
    state = EX.fit_setup("cpu", res=24, tex=16)
    losses = [float(EX.fit_step(state)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    mesh = state["mesh"]
    fresh = TMesh(vertices=mesh.vertices.detach(), faces=mesh.faces,
                  face_uvs=mesh.face_uvs)
    np.testing.assert_array_equal(mesh.face_tangents.detach().numpy(),
                                  fresh.face_tangents.numpy())


def _tie_case():
    """``grid_faces``' 32 faces on a grid of squares split along their
    diagonals, in two depth layers, so every pixel on a diagonal or a
    cell edge has hits of equal depth, and pixels on those edges."""
    fvi = np.concatenate([grid_faces(4), grid_faces(4) * 0.5], 1)
    f = fvi.shape[1]
    fvz = np.repeat(np.where(np.arange(f) < f // 2, -2.0, -3.0)[:, None], 3,
                    1).astype(np.float32)[None]
    fvz[0, ::5] = -2.0         # some faces of both layers at one depth
    xs = (np.arange(-4, 5) * 0.125).astype(np.float32)
    edges = np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2)
    rng = np.random.RandomState(7)
    pix = np.concatenate([edges, rng.uniform(-0.6, 0.6, (40, 2))]).astype(
        np.float32)[None]
    ranges = np.broadcast_to(np.array([-10.0, 0.0], np.float32),
                             pix.shape).copy()
    feat = rng.rand(1, f, 3, 2).astype(np.float32)
    return pix, ranges, fvz, fvi.astype(np.float32), feat


DEFTET_CHUNKS = (1024, 7)
DEFTET_COTANGENT = np.random.RandomState(8).randn(1, 121, 8, 2).astype(
    np.float32)


def deftet_kw(face_chunk):
    return dict(knum=8, face_chunk=face_chunk, pixel_chunk=16)


def jax_deftet(face_chunk):
    """JAX's DefTet of ``_tie_case`` (eager) → (features, face_idx, the
    gradients of the features · ``DEFTET_COTANGENT`` in the vertices and
    the features), numpy."""
    pix, ranges, fvz, fvi, feat = map(jnp.asarray, _tie_case())
    kw = deftet_kw(face_chunk)

    def jloss(v, f):
        out, _ = jdeftet(pix, ranges, fvz, v, f, **kw)
        return jnp.sum(out * DEFTET_COTANGENT)

    out, idx = jdeftet(pix, ranges, fvz, fvi, feat, **kw)
    gv, gf = jax.grad(jloss, argnums=(0, 1))(fvi, feat)
    return tuple(np.asarray(x) for x in (out, idx, gv, gf))


@pytest.mark.parametrize("face_chunk", DEFTET_CHUNKS)
def test_deftet_ids_features_and_gradients_match_jax(face_chunk, jax_refs):
    """On the dense route (all 64 faces in one chunk) and the streamed one
    (chunks of 7, pixels in blocks of 16): ties on shared edges come in
    ascending face order, face_idx equal to JAX's, features within 1e-6,
    the gradients in the vertices and features within 1e-5 of max|g|."""
    pix, ranges, fvz, fvi, feat = _tie_case()
    want_out, want_idx, gv, gf = jax_refs["deftet", face_chunk]
    v = torch.from_numpy(fvi).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    out, idx = tdeftet(torch.from_numpy(pix), torch.from_numpy(ranges),
                       torch.from_numpy(fvz), v, f, **deftet_kw(face_chunk))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    ties = want_idx[..., :-1] >= 0
    assert (ties & (want_idx[..., 1:] > want_idx[..., :-1])).any()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=FEAT_TOL)
    torch.sum(out * torch.from_numpy(DEFTET_COTANGENT)).backward()
    for got, w in ((v.grad, gv), (f.grad, gf)):
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_deftet_streamed_route_equals_the_dense_one():
    """The example's 4,992 faces seen at 24²: the streamed search (chunks
    of 1,024 faces, blocks of 100 pixels) gives the dense search's ids."""
    inputs = EX.deftet_inputs(EX.scene("cpu", tex=8), res=24)
    streamed = EX.deftet_render({**inputs, "pixel_chunk": 100}, knum=12)
    dense = tdeftet(knum=12, face_chunk=10 ** 5, **inputs)
    np.testing.assert_array_equal(streamed[1].numpy(), dense[1].numpy())
    for s, d in zip(streamed[0], dense[0]):
        np.testing.assert_array_equal(s.numpy(), d.numpy())


def test_nvdiffrast_stubs():
    """nvdiffrast is absent: ``nvdiffrast_is_available`` is False, the
    default context raises (or gives None when asked not to raise), and a
    context set for a device is returned for it."""
    assert nvdiffrast_is_available() is False
    with pytest.raises(RuntimeError, match="kaolin_tpu_torch.render.mesh"
                                           ".rasterize"):
        default_nvdiffrast_context()
    assert default_nvdiffrast_context("cuda:7", raise_error=False) is None
    ctx = object()
    try:
        assert nvdiffrast_context.set_default_nvdiffrast_context(
            ctx, "cuda:7") is ctx
        assert default_nvdiffrast_context("cuda:7") is ctx
    finally:
        nvdiffrast_context._CONTEXTS.pop("cuda:7", None)
    assert te.mesh_rasterize_interpolate_cuda is te.mesh_rasterize_interpolate
    assert (te.mesh_rasterize_interpolate_nvdiffrast
            is te.mesh_rasterize_interpolate)


@pytest.mark.parametrize("name", ["torch_tutorial_easy_mesh_render",
                                  "torch_tutorial_diffuse_lighting",
                                  "torch_tutorial_sg_specular_lighting"])
def test_tutorial_smoke(name):
    """The three ported lighting and render tutorials at their smoke sizes
    on the CPU; each asserts what its JAX counterpart asserts."""
    load_example(name).main("cpu", smoke=True)

