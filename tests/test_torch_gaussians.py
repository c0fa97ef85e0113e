"""kaolin_tpu_torch's gaussian splats against kaolin_tpu's, on the CPU.

The containers' protocol (``tests/rep/test_gaussians_spec.py`` and
``tests/ops/test_gaussians.py``'s model test, each case run through both
packages), ``transform_gaussians`` and ``transform_shs`` for SH degrees
0-3, ``gs_to_voxelgrid`` at levels 4-5 on 300 gaussians (coords equal,
opacities within 1e-9 relative; a forced small chunk equal to one chunk),
the densifier by flood fill and by carving, the gaussian-splat camera
conversions and the interop helper. The densifier runs on a 300-gaussian
shell like ``examples/torch_simulatable_gaussians.py``'s small scene's, of
scale 0.04; its carving uses ``tests/ops/test_gaussians.py``'s eight views, at 64 pixels
a side (``tests/torch_parity.py::shared_carving_views``).
"""

import contextlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.ops.conversions as jconv
import kaolin_tpu.ops.gaussians as jgs
import kaolin_tpu.render.camera as jcam
from kaolin_tpu.rep import GaussianSplatModel as GJ
from kaolin_tpu.rep import PointSamples as PJ

import kaolin_tpu_torch.ops.conversions.gaussians as tconv_gs
import kaolin_tpu_torch.render.camera as tcam
from kaolin_tpu_torch.ops.conversions import gs_to_voxelgrid
from kaolin_tpu_torch.ops.gaussians import (
    sample_points_in_volume,
    transform_gaussians,
    transform_shs,
)
from kaolin_tpu_torch.rep import GaussianSplatModel as GT
from kaolin_tpu_torch.rep import PointSamples as PT
from kaolin_tpu_torch.utils.interop import gaussian_splat_model_from_jax
from tests.torch_parity import (  # noqa: F401
    CARVE_VIEWS,
    jax_voxels_memoized,
    jax_without_contraction,
    load_example,
    shared_carving_views,
    torch_threads_per_worker,
    warm_torch_exp,
)

sg = load_example("torch_simulatable_gaussians")

SHELL = (300, 0.04)   # gaussians, scale


def model_arrays(seed=0, n=40, sh_deg=1):
    """``tests/rep/test_gaussians_spec.py``'s ``_rng_model`` draws."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return dict(positions=rng.randn(n, 3).astype(np.float32),
                orientations=q.astype(np.float32),
                scales=(rng.rand(n, 3) + 0.1).astype(np.float32),
                opacities=rng.rand(n).astype(np.float32),
                sh_coeff=rng.randn(n, (sh_deg + 1) ** 2, 3)
                .astype(np.float32))


def models(seed=0, n=40, sh_deg=1, transform=None):
    """The same model in both packages → (JAX's, the port's)."""
    a = model_arrays(seed, n, sh_deg)
    jm = GJ(**{k: jnp.asarray(v) for k, v in a.items()},
            transform=None if transform is None else jnp.asarray(transform))
    tm = GT(**{k: torch.from_numpy(v) for k, v in a.items()},
            transform=None if transform is None
            else torch.from_numpy(transform))
    return jm, tm


def translation(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def assert_models_equal(jm, tm, atol=0.0):
    assert type(tm).__name__ == type(jm).__name__
    assert len(tm) == len(jm)
    for a in jm.class_tensor_attributes():
        jv, tv = getattr(jm, a, None), getattr(tm, a, None)
        assert (jv is None) == (tv is None), a
        if jv is not None:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=atol, rtol=0, err_msg=a)
    for a in jm.class_other_attributes():
        assert getattr(tm, a) == getattr(jm, a), a


# -- transforms ----------------------------------------------------------
def random_transform(seed, scale=(1.0, 1.0, 1.0)):
    from scipy.spatial.transform import Rotation
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = Rotation.random(random_state=seed).as_matrix() \
        * np.asarray(scale)[None]
    t[:3, 3] = np.random.RandomState(seed).randn(3)
    return t


@pytest.mark.parametrize("sh_deg", [0, 1, 2, 3])
@pytest.mark.parametrize("use_log_scales,use_xyzw,scale", [
    (False, False, (1.0, 1.0, 1.0)), (False, False, (2.0, 0.5, 1.5)),
    (True, False, (2.0, 0.5, 1.5)), (False, True, (0.7, 0.7, 0.7))])
def test_transform_gaussians_matches_jax(sh_deg, use_log_scales, use_xyzw,
                                         scale):
    a = model_arrays(5, n=40, sh_deg=sh_deg)
    t = random_transform(sh_deg + 10, scale)
    want = jgs.transform_gaussians(
        jnp.asarray(a["positions"]), jnp.asarray(a["orientations"]),
        jnp.asarray(a["scales"]), jnp.asarray(t),
        sh_coeff=jnp.asarray(a["sh_coeff"]), use_log_scales=use_log_scales,
        use_xyzw=use_xyzw)
    got = transform_gaussians(
        torch.from_numpy(a["positions"]), torch.from_numpy(a["orientations"]),
        torch.from_numpy(a["scales"]), torch.from_numpy(t),
        sh_coeff=torch.from_numpy(a["sh_coeff"]),
        use_log_scales=use_log_scales, use_xyzw=use_xyzw)
    for w, g, name in zip(want, got, ("positions", "orientations", "scales",
                                      "sh")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    no_sh = transform_gaussians(torch.from_numpy(a["positions"]),
                                torch.from_numpy(a["orientations"]),
                                torch.from_numpy(a["scales"]),
                                torch.from_numpy(t))
    assert no_sh[3] is None


@pytest.mark.parametrize("sh_deg", [0, 1, 2, 3])
def test_transform_shs_matches_jax(sh_deg):
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(sh_deg)
    sh = rng.randn(9, (sh_deg + 1) ** 2, 3).astype(np.float32)
    r = Rotation.random(9, random_state=sh_deg).as_matrix().astype(
        np.float32)
    for rr in (r, r[:1]):
        want = np.asarray(jgs.transform_shs(jnp.asarray(sh), jnp.asarray(rr)))
        got = transform_shs(torch.from_numpy(sh), torch.from_numpy(rr))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if sh_deg == 3:
        with pytest.raises(NotImplementedError):
            transform_shs(torch.zeros((1, 25, 3)), torch.eye(3))


# -- containers ----------------------------------------------------------
def test_default_construction_fills_identity_attrs():
    jm = GJ(positions=jnp.zeros((5, 3)))
    tm = GT(positions=torch.zeros((5, 3)))
    assert_models_equal(jm, tm)
    assert tm.sh_degree == 0 and tm.orientations.dtype == torch.float32


def test_sh_degree_helpers():
    for n in (1, 4, 9, 16):
        assert GT.compute_sh_degree(n) == GJ.compute_sh_degree(n)
    assert GT.compute_num_sh_coeff(2) == GJ.compute_num_sh_coeff(2) == 9
    with pytest.raises(ValueError):
        GT.compute_sh_degree(5)


@pytest.mark.parametrize("mask_kind", ["numpy", "tensor"])
def test_getitem_selects_all_point_attributes(mask_kind):
    jm, tm = models(n=10)
    mask = np.zeros(10, bool)
    mask[[1, 4, 7]] = True
    tmask = mask if mask_kind == "numpy" else torch.from_numpy(mask)
    assert_models_equal(jm[mask], tm[tmask])
    with pytest.raises(TypeError):
        tm[np.arange(10)]
    with pytest.raises(ValueError):
        tm[np.ones(9, bool)]


def test_setitem_writes_back():
    jm, tm = models(n=10)
    mask = np.zeros(10, bool)
    mask[[0, 3]] = True
    before = tm.positions
    jsub, tsub = jm[mask], tm[mask]
    jm[mask] = GJ(positions=jsub.positions + 1.0,
                  orientations=jsub.orientations, scales=jsub.scales,
                  opacities=jsub.opacities, sh_coeff=jsub.sh_coeff)
    tm[mask] = GT(positions=tsub.positions + 1.0,
                  orientations=tsub.orientations, scales=tsub.scales,
                  opacities=tsub.opacities, sh_coeff=tsub.sh_coeff)
    assert_models_equal(jm, tm)
    # a new tensor, as JAX's .at[].set: the old one is left as it was
    np.testing.assert_array_equal(before.numpy(),
                                  model_arrays(n=10)["positions"])


def test_cat_concatenates_points():
    (ja, ta), (jb, tb) = models(0, n=4), models(1, n=6)
    assert_models_equal(GJ.cat([ja, jb]), GT.cat([ta, tb]))


def test_cat_bakes_stored_transforms():
    (ja, ta) = models(0, transform=translation([1.0, 0.0, 0.0]))
    (jb, tb) = models(1, n=3)
    out = GT.cat([ta, tb])
    assert out.transform is None
    assert_models_equal(GJ.cat([ja, jb]), out, atol=1e-6)


def test_cat_empty_and_single():
    with pytest.raises(ValueError):
        GT.cat([])
    _, ta = models(0, n=4)
    assert GT.cat([ta]) is ta


def test_point_samples_cat_mismatched_features():
    a = PT(positions=torch.zeros((3, 3)), features=torch.ones((3, 2)))
    b = PT(positions=torch.ones((2, 3)))
    with pytest.raises(ValueError):
        PT.cat([a, b])
    out = PT.cat([a, b], skip_errors=True)
    want = PJ.cat([PJ(positions=jnp.zeros((3, 3)),
                      features=jnp.ones((3, 2))),
                   PJ(positions=jnp.ones((2, 3)))], skip_errors=True)
    assert len(out) == len(want) == 5
    assert getattr(out, "features", None) is None
    np.testing.assert_array_equal(out.positions.numpy(),
                                  np.asarray(want.positions))


def test_as_transformed_composition():
    jm, tm = models(0, transform=translation([0.0, 2.0, 0.0]))
    t2 = translation([1.0, 0.0, 0.0])
    out = tm.as_transformed(torch.from_numpy(t2))
    assert_models_equal(jm.as_transformed(jnp.asarray(t2)), out, atol=1e-6)
    np.testing.assert_allclose(
        out.positions.numpy(),
        model_arrays()["positions"] + np.array([1.0, 2.0, 0.0]),
        rtol=1e-6)


def test_as_transformed_rotation_and_scale():
    """A rotation about a skew axis with a scale of 1.5 baked into every
    attribute, SH degree 3, against JAX within 1e-5."""
    angle, axis = 0.9, np.array([1.0, 2.0, -0.5]) / np.linalg.norm(
        [1.0, 2.0, -0.5])
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = 1.5 * rot
    t[:3, 3] = [0.3, -0.2, 0.1]
    jm, tm = models(2, sh_deg=3, transform=t)
    assert_models_equal(jm.as_transformed(), tm.as_transformed(), atol=1e-5)


def test_float_tensors_to_and_device_moves():
    jm, tm = models(0, n=4)
    jout = jm.float_tensors_to(jnp.float16)
    out = tm.float_tensors_to(torch.float16)
    assert out is tm
    assert out.positions.dtype == out.sh_coeff.dtype == torch.float16
    np.testing.assert_array_equal(out.positions.numpy(),
                                  np.asarray(jout.positions))
    # .to / .cpu move and cast (no-ops in the JAX package)
    moved = tm.to("cpu", torch.float64)
    assert moved is tm and tm.scales.dtype == torch.float64
    assert tm.cpu().positions.device.type == "cpu"
    assert "positions: (4, 3)" in tm.describe_attribute("positions")
    assert repr(tm).startswith("GaussianSplatModel(num_points=4")


def test_from_gaussian_dict():
    rng = np.random.RandomState(3)
    d = {"positions": rng.randn(8, 3).astype(np.float32),
         "rotations": rng.randn(8, 4).astype(np.float32),
         "scales": rng.randn(8, 3).astype(np.float32),
         "opacities": rng.randn(8, 1).astype(np.float32),
         "sh_coeffs": rng.randn(8, 4, 3).astype(np.float32)}
    for activated in (True, False):
        assert_models_equal(
            GJ.from_gaussian_dict(d, activated=activated),
            GT.from_gaussian_dict({k: torch.from_numpy(v)
                                   for k, v in d.items()},
                                  activated=activated), atol=1e-6)


def test_gaussian_splat_model_from_jax():
    jm, _ = models(4, n=7, sh_deg=2, transform=translation([0, 1, 0]))
    tm = gaussian_splat_model_from_jax(jm)
    assert_models_equal(jm, tm)
    assert tm.sh_degree == 2


# -- voxelization ----------------------------------------------------------
def voxel_inputs(n=300, seed=0):
    """Anisotropic, rotated gaussians of random opacity about a sphere of
    radius 0.5."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((0.5 * d).astype(np.float32),
            (0.06 * rng.uniform(0.5, 1.5, (n, 3))).astype(np.float32),
            rng.randn(n, 4).astype(np.float32),
            rng.uniform(0.2, 1.0, (n,)).astype(np.float32))


@pytest.mark.parametrize("level", [4, 5])
def test_gs_to_voxelgrid_matches_jax(level, monkeypatch):
    a = voxel_inputs()
    jp, jo = jconv.gs_to_voxelgrid(*a, level=level)
    tp, to = gs_to_voxelgrid(*[torch.from_numpy(x) for x in a], level=level)
    assert tp.dtype == torch.int16 and to.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jo = np.asarray(jo)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-9, atol=0)
    # chunks of at most 5,000 candidates (6 and 30 of them) give the same grid
    monkeypatch.setattr(tconv_gs, "MAX_CANDIDATES", 5000)
    cp, co = gs_to_voxelgrid(*[torch.from_numpy(x) for x in a], level=level)
    assert torch.equal(cp, tp) and torch.equal(co, to)
    # arrays run where device= says
    ap, _ = gs_to_voxelgrid(*a, level=level, device="cpu")
    assert torch.equal(ap, tp)


def test_gs_to_voxelgrid_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gs_to_voxelgrid(*voxel_inputs(10), level=4)


# -- camera conversions ----------------------------------------------------
def cameras(res=64):
    kw = dict(at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov=0.8, width=res,
              height=res + 16)
    eye = np.array([1.0, 2.0, 3.0], np.float32)
    return (jcam.Camera.from_args(eye=jnp.asarray(eye), **kw),
            tcam.Camera.from_args(eye=torch.from_numpy(eye), **kw))


def test_nerfstudio_conversions_match_jax():
    jc, tc = cameras()
    want = jcam.kaolin_camera_to_gsplat_nerfstudio(jc)
    got = tcam.kaolin_camera_to_gsplat_nerfstudio(tc)
    for k in ("viewmats", "Ks"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    for k in ("width", "height", "camera_model"):
        assert got[k] == want[k]
    back = tcam.gsplat_nerfstudio_camera_to_kaolin(
        got["Ks"], got["viewmats"], got["width"], got["height"])
    jback = jcam.gsplat_nerfstudio_camera_to_kaolin(
        want["Ks"], want["viewmats"], want["width"], want["height"])
    np.testing.assert_allclose(back.extrinsics.view_matrix().numpy(),
                               tc.extrinsics.view_matrix().numpy(), atol=1e-5)
    np.testing.assert_allclose(back.extrinsics.view_matrix().numpy(),
                               np.asarray(jback.extrinsics.view_matrix()),
                               atol=1e-6)
    np.testing.assert_allclose(back.intrinsics.focal_y.numpy(),
                               np.asarray(jback.intrinsics.focal_y),
                               rtol=1e-6)


def test_inria_conversions_match_jax():
    jc, tc = cameras()
    want = jcam.kaolin_camera_to_gsplat_inria(jc)
    got = tcam.kaolin_camera_to_gsplat_inria(tc)
    assert set(got) == set(want)
    for k in ("R", "T"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)
    for k in ("FoVx", "FoVy"):
        assert abs(got[k] - want[k]) < 1e-6
    with pytest.warns(DeprecationWarning):
        assert tcam.kaolin_camera_to_gsplats(tc).keys() == got.keys()

    wvt = tc.extrinsics.view_matrix()[0].numpy().copy()
    wvt[1:3] = -wvt[1:3]
    gs = {"world_view_transform": torch.from_numpy(wvt.T.copy()),
          "image_width": 64, "image_height": 80, "FoVy": got["FoVy"]}
    back = tcam.gsplat_inria_camera_to_kaolin(gs)
    jback = jcam.gsplat_inria_camera_to_kaolin(
        {**gs, "world_view_transform": wvt.T.copy()})
    np.testing.assert_allclose(back.extrinsics.view_matrix().numpy(),
                               tc.extrinsics.view_matrix().numpy(), atol=1e-6)
    np.testing.assert_allclose(back.intrinsics.focal_y.numpy(),
                               np.asarray(jback.intrinsics.focal_y),
                               rtol=1e-6)
    with pytest.warns(DeprecationWarning):
        tcam.gsplats_camera_to_kaolin(gs)


def test_polyscope_conversions_need_polyscope():
    """Without polyscope both packages' conversions raise ImportError; with
    a stand-in camera object the view matrix and fov carry over."""
    import importlib.util
    if importlib.util.find_spec("polyscope") is None:
        _, tc = cameras()
        with pytest.raises(ImportError):
            tcam.kaolin_camera_to_polyscope(tc)
        with pytest.raises(ImportError):
            jcam.kaolin_camera_to_polyscope(cameras()[0])

    class PsCamera:
        def get_view_mat(self):
            return np.diag([1.0, 1.0, 1.0, 1.0]) + np.eye(4, k=3) * 2.0

        def get_fov_vertical_deg(self):
            return 45.0

    got = tcam.polyscope_camera_to_kaolin(PsCamera(), 32, 24, device="cpu")
    want = jcam.polyscope_camera_to_kaolin(PsCamera(), 32, 24)
    np.testing.assert_allclose(got.extrinsics.view_matrix().numpy(),
                               np.asarray(want.extrinsics.view_matrix()),
                               atol=1e-6)
    np.testing.assert_allclose(got.intrinsics.focal_y.numpy(),
                               np.asarray(want.intrinsics.focal_y),
                               rtol=1e-6)


# -- densifier -------------------------------------------------------------
@contextlib.contextmanager
def _warnings():
    """The densifier's log records at WARNING and above."""
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("kaolin_tpu_torch.ops.gaussians.densifier")
    log.addHandler(handler)
    try:
        yield records
    finally:
        log.removeHandler(handler)


@pytest.fixture(scope="module")
def shell():
    """300 gaussians of scale 0.04 on a sphere of radius 0.4 about (0, 0.6,
    0)."""
    gaussians, _ = sg.shell_gaussians(*SHELL)
    return gaussians


@pytest.fixture(scope="module")
def densified(shell):
    """Both packages' densifiers by flood fill and by carving at level 6,
    no jitter and no subsample, made on first use."""
    cache = {}

    def get(method):
        if method not in cache:
            kw = dict(octree_level=6, method=method, viewpoints=CARVE_VIEWS,
                      jitter=False, num_samples=None)
            with jax_voxels_memoized(), shared_carving_views(6), \
                    jax_without_contraction():
                want = np.asarray(jgs.sample_points_in_volume(*shell, **kw))
                got = sample_points_in_volume(*shell, device="cpu", **kw)
            cache[method] = want, got
        return cache[method]
    return get


@pytest.mark.parametrize("method", ["floodfill", "carve"])
def test_densifier_matches_jax(densified, shell, method):
    with _warnings() as records:
        want, got = densified(method)
    assert not records
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the interior is filled
    r = np.linalg.norm(got.numpy() - np.array([0.0, 0.6, 0.0]), axis=1)
    assert (r < 0.2).mean() > 0.02


def test_densifier_jitter_and_subsample_contracts(densified, shell):
    """The random parts against their contracts: the jitter stays within the
    cell radius of its voxel center; ``num_samples`` distinct rows of the
    set without it. A carve that fails falls back to the flood fill with
    JAX's warning (the function's semantics)."""
    import kaolin_tpu_torch.ops.gaussians.densifier as dens

    base, _ = densified("floodfill")
    xyz = shell[0]
    dmax = 0.5 * float((xyz.max(0) - xyz.min(0)).max()) + 0.05
    kw = dict(octree_level=6, device="cpu")
    jittered = sample_points_in_volume(
        *shell, method="floodfill", num_samples=None,
        clip_samples_to_input_bbox=False,
        key=torch.Generator().manual_seed(1), **kw)
    with pytest.MonkeyPatch.context() as mp:
        # the fallback: no carving, so the flood fill's points unclipped
        mp.setattr(dens, "_carve_interior", lambda *a, **k: None)
        with _warnings() as records:
            unclipped = sample_points_in_volume(
                *shell, method="carve", num_samples=None, jitter=False,
                clip_samples_to_input_bbox=False, **kw)
    assert [r for r in records if "Falling back" in r.getMessage()]
    assert jittered.shape == unclipped.shape
    cell = 2.0 / 64 * dmax
    step = torch.linalg.vector_norm(jittered - unclipped, dim=1)
    assert float(step.max()) <= cell * (1 + 1e-5) and float(step.max()) > 0
    sub = sample_points_in_volume(*shell, method="floodfill", num_samples=500,
                                  jitter=False, key=3, **kw)
    rows = {tuple(r) for r in base.tolist()}
    picked = [tuple(r) for r in sub.numpy().tolist()]
    assert sub.shape == (500, 3) and len(set(picked)) == 500
    assert all(p in rows for p in picked)


def test_default_viewpoints_match_jax():
    import kaolin_tpu.ops.gaussians.densifier as jd

    import kaolin_tpu_torch.ops.gaussians.densifier as td
    want = jd._generate_default_viewpoints()
    got = td._generate_default_viewpoints()
    assert got.shape == (86, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
