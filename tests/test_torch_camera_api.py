"""The port's camera API beyond the SPC raster's part (``legacy.py``,
``extrinsics_backends.py``, the rest of ``extrinsics.py``,
``intrinsics.py`` and ``camera.py``, ``coordinates.py`` and
``trajectory.py``) against kaolin_tpu's, on the CPU.

The same numpy eyes, angles and points go to both packages. Matrices,
transforms and parameters agree within 1e-5 absolute (float32; the two take
norms and cross products in other summation orders; the trajectories
interpolate in float64 on the host and then round); index lists, masks,
dict keys and flags agree exactly. The gradient through
``Camera.parameters()`` agrees with ``jax.grad`` within 1e-5 relative.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render import camera as jcam
from kaolin_tpu.render.camera import extrinsics as jext
from kaolin_tpu.render.camera import extrinsics_backends as jback
from kaolin_tpu.render.camera import intrinsics as jint
from kaolin_tpu_torch.render import camera as tcam
from kaolin_tpu_torch.render.camera import extrinsics as text
from kaolin_tpu_torch.render.camera import extrinsics_backends as tback
from kaolin_tpu_torch.render.camera import intrinsics as tint
from tests.torch_parity import warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

ATOL = 1e-5
EYES = np.array([[1.4, 1.0, 1.3], [-1.8, -0.4, 0.6], [0.3, 2.0, -1.1]],
                np.float32)
AT = np.array([0.1, 0.0, -0.2], np.float32)
UP = np.array([0.0, 1.0, 0.0], np.float32)
PTS = np.random.RandomState(0).uniform(-1, 1, (20, 3)).astype(np.float32)


def close(got, want, atol=ATOL, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def cams(lens="fov", backend="matrix_se3", **extra):
    args = {"fov": dict(fov=0.9), "focal": dict(focal_x=40.0, focal_y=30.0),
            "ortho": dict(fov_distance=1.5)}[lens]
    args.update(width=40, height=24, backend=backend, **extra)
    j = jcam.Camera.from_args(eye=jnp.asarray(EYES), at=jnp.asarray(AT),
                              up=jnp.asarray(UP), **args)
    t = tcam.Camera.from_args(eye=torch.from_numpy(EYES),
                              at=torch.from_numpy(AT),
                              up=torch.from_numpy(UP), **args)
    return j, t


# -- legacy.py -----------------------------------------------------------
def test_legacy_transformation_and_projection():
    pos, look, up = EYES, np.zeros((1, 3), np.float32), UP[None]
    m_t = tcam.generate_transformation_matrix(
        torch.from_numpy(pos), torch.from_numpy(look), torch.from_numpy(up))
    m_j = jcam.generate_transformation_matrix(
        jnp.asarray(pos), jnp.asarray(look), jnp.asarray(up))
    close(m_t, m_j)
    for ratio in (1.0, 1.5):
        close(tcam.generate_perspective_projection(np.pi / 3, ratio),
              jcam.generate_perspective_projection(np.pi / 3, ratio))
    proj = jcam.generate_perspective_projection(np.pi / 3)
    pts_cam = np.asarray(jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(PTS), (3, 20, 3)),
         jnp.ones((3, 20, 1))], -1) @ m_j)
    close(tcam.perspective_camera(torch.from_numpy(pts_cam),
                                  torch.from_numpy(np.asarray(proj))),
          jcam.perspective_camera(jnp.asarray(pts_cam), proj))


def test_legacy_rotate_translate():
    pos, look = EYES, np.zeros((3, 3), np.float32)
    r_t, t_t = tcam.generate_rotate_translate_matrices(
        torch.from_numpy(pos), torch.from_numpy(look),
        torch.from_numpy(UP[None]))
    r_j, t_j = jcam.generate_rotate_translate_matrices(
        jnp.asarray(pos), jnp.asarray(look), jnp.asarray(UP[None]))
    close(r_t, r_j)
    close(t_t, t_j)
    pts = np.broadcast_to(PTS, (3, 20, 3)).copy()
    close(tcam.rotate_translate_points(torch.from_numpy(pts), r_t, t_t),
          jcam.rotate_translate_points(jnp.asarray(pts), r_j, t_j))
    assert tcam.legacy.generate_perspective_projection is \
        tcam.generate_perspective_projection


# -- extrinsics ----------------------------------------------------------
@pytest.mark.parametrize("backend", ["matrix_se3", "matrix_6dof_rotation"])
def test_extrinsics_api_matches_jax(backend):
    j, t = cams(backend=backend)
    je, te = j.extrinsics, t.extrinsics
    close(te.params, je.params)
    close(te.R, je.R)
    close(te.t, je.t)
    for name in ("cam_pos", "cam_right", "cam_up", "cam_forward",
                 "view_matrix", "inv_view_matrix"):
        close(getattr(te, name)(), getattr(je, name)())
    moved = [(lambda e: e.rotate(yaw=0.3, pitch=-0.2, roll=0.1)),
             (lambda e: e.rotate(pitch=0.4)),
             (lambda e: e.translate([0.1, -0.2, 0.3])),
             (lambda e: e.move_right(0.5)), (lambda e: e.move_up(-0.25)),
             (lambda e: e.move_forward(0.75)),
             (lambda e: e.switch_backend("matrix_se3")),
             (lambda e: e.switch_backend("matrix_6dof_rotation")),
             (lambda e: e.update(e.view_matrix()[np.array([2, 0, 1])]))]
    for fn in moved:
        a, b = fn(te), fn(je)
        assert a.backend == b.backend
        close(a.view_matrix(), b.view_matrix())
        close(a.params, b.params)
    assert te.available_backends()[:2] == je.available_backends()[:2]
    for p in ("R", "t", tback.ExtrinsicsParamsDefEnum.t):
        jp = p if isinstance(p, str) else jback.ExtrinsicsParamsDefEnum.t
        assert te.param_idx(p) == je.param_idx(jp)
        close(te.gradient_mask(p), je.gradient_mask(jp), atol=0)
    assert te.parameters() is te.params


def test_extrinsics_coordinate_systems():
    j, t = cams()
    for basis in ("blender_coords", "opengl_coords"):
        pj = getattr(jcam, basis)()
        pt = getattr(tcam, basis)()
        close(pt, pj, atol=0)
        a = t.extrinsics.change_coordinate_system(pt)
        b = j.extrinsics.change_coordinate_system(pj)
        close(a.view_matrix(), b.view_matrix())
        close(a.basis_change_matrix, b.basis_change_matrix, atol=0)
        a2 = a.change_coordinate_system(pt)
        b2 = b.change_coordinate_system(pj)
        close(a2.basis_change_matrix, b2.basis_change_matrix, atol=0)
        close(a2.reset_coordinate_system().view_matrix(),
              b2.reset_coordinate_system().view_matrix())
        close(a2.reset_coordinate_system().view_matrix(),
              t.extrinsics.view_matrix())


def test_extrinsics_batching_and_dicts():
    j, t = cams()
    je, te = j.extrinsics, t.extrinsics
    close(text.CameraExtrinsics.cat([te, te[1]]).params,
          jext.CameraExtrinsics.cat([je, je[1]]).params)
    close(te[1:].params, je[1:].params)
    assert len(te[0]) == 1
    assert text.allclose(te, te[[0, 1, 2]])
    assert not text.allclose(te, te.move_up(1e-3))
    assert not text.allclose(te, te.switch_backend("matrix_6dof_rotation"))
    d = te.change_coordinate_system(tcam.blender_coords()).to_dict()
    dj = je.change_coordinate_system(jcam.blender_coords()).to_dict()
    assert d.keys() == dj.keys() and d["backend"] == dj["backend"]
    close(np.array(d["params"]), np.array(dj["params"]))
    assert d["base_change"] == dj["base_change"]
    back = text.CameraExtrinsics.from_dict(d)
    assert text.allclose(back, te.change_coordinate_system(
        tcam.blender_coords())) and back._base_change is not None
    assert te.as_dict() == te.to_dict()
    for a, b in zip(te.named_params(), je.named_params()):
        close(a["R"], b["R"])
        close(a["t"], b["t"])
    with pytest.raises(ValueError):
        text.CameraExtrinsics.from_dict({"classname": "Camera"})


def _register(module, name):
    """The same custom backend in one package: (t, then R's rows)."""
    np_ = jnp if module is jback else torch

    @module.register_backend(name)
    class TFirst(module.ExtrinsicsRep):
        @classmethod
        def params_from_Rt(cls, R, t):
            return np_.concatenate([t, R.reshape(-1, 9)], -1) \
                if np_ is jnp else torch.cat([t, R.reshape(-1, 9)], -1)

        @classmethod
        def R(cls, params):
            return params[:, 3:].reshape(-1, 3, 3)

        @classmethod
        def t(cls, params):
            return params[:, :3, None]

        @classmethod
        def param_idx(cls, param):
            return [0, 1, 2] if int(param) == 1 else list(range(3, 12))

    return TFirst


def test_registered_backend():
    _register(jback, "t_first")
    _register(tback, "t_first")
    assert tback.get_backend("t_first") is not None
    assert "t_first" in text.CameraExtrinsics.available_backends()
    j, t = cams(backend="t_first")
    close(t.extrinsics.params, j.extrinsics.params)
    close(t.extrinsics.view_matrix(), j.extrinsics.view_matrix())
    assert t.extrinsics.param_idx("t") == [0, 1, 2]
    with pytest.raises(TypeError):
        tback.register_backend("bad")(object)
    with pytest.raises(ValueError):
        text.CameraExtrinsics._from_R_t(t.extrinsics.R, t.extrinsics.t,
                                        "no_such_backend")


# -- intrinsics ----------------------------------------------------------
@pytest.mark.parametrize("lens", ["fov", "focal", "ortho"])
def test_intrinsics_api_matches_jax(lens):
    j, t = cams(lens)
    ji, ti = j.intrinsics, t.intrinsics
    close(ti.projection_matrix(), ji.projection_matrix())
    close(ti.viewport_matrix(), ji.viewport_matrix())
    close(ti.viewport_matrix(2, 30, 1, 20, 0.1, 0.9),
          ji.viewport_matrix(2, 30, 1, 20, 0.1, 0.9))
    depth = np.array([0.001, 0.5, 3.0, 200.0], np.float32)
    close(ti.normalize_depth(torch.from_numpy(depth)),
          ji.normalize_depth(jnp.asarray(depth)))
    close(ti.clip_mask(torch.from_numpy(depth)),
          ji.clip_mask(jnp.asarray(depth)), atol=0)
    assert ti.aspect_ratio() == ji.aspect_ratio()
    assert ti.param_types() == ji.param_types()
    assert ti.param_count() == ji.param_count()
    for a, b in zip(ti.named_params(), ji.named_params()):
        assert a.keys() == b.keys()
        close(np.array(list(a.values())), np.array(list(b.values())))
    names = ti.param_types()
    close(ti.gradient_mask(*names[:1]), ji.gradient_mask(*names[:1]), atol=0)
    close(ti.zoom(5.0).params, ji.zoom(5.0).params, atol=1e-4)
    close(type(ti).cat([ti, ti[0]]).params, type(ji).cat([ji, ji[0]]).params)
    d = ti.as_dict()
    assert d == {**ji.as_dict(), "params": d["params"]}
    assert tint.allclose(tint.CameraIntrinsics.from_dict(d), ti)
    assert not tint.allclose(ti, ti.zoom(1.0))
    with pytest.raises(NotImplementedError):
        ti.set_ndc_range(0.0, 1.0)
    with pytest.raises(ValueError):
        ti.gradient_mask("no_such_param")


@pytest.mark.parametrize("direction", list(tcam.CameraFOV))
def test_pinhole_fov_and_principal_point(direction):
    j, t = cams("focal", x0=1.5, y0=-2.0)
    jd = jcam.CameraFOV[direction.name]
    for deg in (True, False):
        close(t.intrinsics.fov(direction, in_degrees=deg),
              j.intrinsics.fov(jd, in_degrees=deg), atol=1e-4)
    close(t.intrinsics.cx, j.intrinsics.cx)
    close(t.intrinsics.cy, j.intrinsics.cy)


@pytest.mark.parametrize("ndc", [(0.0, 1.0), (1.0, 0.0)])
def test_ndc_ranges(ndc):
    p = np.array([[0.5, -0.5, 40.0, 30.0]], np.float32)
    ji = jint.PinholeIntrinsics(40, 24, jnp.asarray(p), 0.1, 50.0, *ndc)
    ti = tint.PinholeIntrinsics(40, 24, torch.from_numpy(p), 0.1, 50.0,
                                *ndc)
    close(ti.projection_matrix(), ji.projection_matrix(), atol=1e-4)
    depth = np.array([0.2, 1.0, 20.0], np.float32)
    close(ti.normalize_depth(torch.from_numpy(depth)),
          ji.normalize_depth(jnp.asarray(depth)))
    close(ti.viewport_matrix(), ji.viewport_matrix())


def test_params_enums():
    for tcls, jcls in ((tcam.PinholeParamsDefEnum, jint.PinholeParamsDefEnum),
                       (tcam.OrthoParamsDefEnum, jint.OrthoParamsDefEnum),
                       (tcam.ExtrinsicsParamsDefEnum,
                        jback.ExtrinsicsParamsDefEnum)):
        assert [(m.name, int(m)) for m in tcls] == \
            [(m.name, int(m)) for m in jcls]
    assert issubclass(tcam.PinholeParamsDefEnum, tcam.IntrinsicsParamsDefEnum)
    _, t = cams("focal")
    close(t.intrinsics.gradient_mask(tcam.PinholeParamsDefEnum.focal_y),
          np.array([[0, 0, 0, 1]] * 3, bool), atol=0)


# -- camera --------------------------------------------------------------
@pytest.mark.parametrize("lens", ["fov", "ortho"])
def test_camera_api_matches_jax(lens):
    j, t = cams(lens)
    close(t.view_projection_matrix(), j.view_projection_matrix())
    close(t[1].view_projection_matrix(), j[1].view_projection_matrix())
    close(tcam.Camera.cat([t, t[0]]).view_projection_matrix(),
          jcam.Camera.cat([j, j[0]]).view_projection_matrix())
    for a, b in zip(t.named_params(), j.named_params()):
        assert a.keys() == b.keys()
    mt, mj = t.gradient_mask("t", t.intrinsics.param_types()[-1])
    mjx, mji = j.gradient_mask("t", j.intrinsics.param_types()[-1])
    close(mt, mjx, atol=0)
    close(mj, mji, atol=0)
    d = t.to_dict()
    assert d.keys() == j.to_dict().keys()
    assert tcam.allclose(tcam.Camera.from_dict(d), t)
    assert not tcam.allclose(t, tcam.Camera.cat([t[1], t[0], t[2]]))
    pe, pi = t.parameters()
    assert pe is t.extrinsics.params and pi is t.intrinsics.params


@pytest.mark.parametrize("backend", ["matrix_se3", "matrix_6dof_rotation"])
def test_gradient_through_camera_parameters(backend):
    """d/d(params) of sum(w · camera.transform(points)), through
    ``Camera.parameters()`` made to require grad, against ``jax.grad``
    over the JAX camera's params."""
    j, t = cams("focal", backend=backend)
    w = np.random.RandomState(1).randn(3, 20, 3).astype(np.float32)

    def loss_j(pe, pi):
        cam = jcam.Camera(jext.CameraExtrinsics(pe, backend=backend),
                          jint.PinholeIntrinsics(40, 24, pi))
        return jnp.sum(jnp.asarray(w) * cam.transform(jnp.asarray(PTS)))

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(j.extrinsics.params,
                                                   j.intrinsics.params)
    pe, pi = t.parameters()
    pe.requires_grad_(True)
    pi.requires_grad_(True)
    (torch.from_numpy(w) * t.transform(torch.from_numpy(PTS))).sum() \
        .backward()
    close(pe.grad, gj[0], atol=1e-4, rtol=1e-5)
    close(pi.grad, gj[1], atol=1e-4, rtol=1e-5)
    me, _ = t.gradient_mask("t")
    assert bool(me[:, -3:].all()) and not bool(me[:, :-3].any())


# -- trajectory ----------------------------------------------------------
def _ring(module, n, lens):
    out = []
    for k in range(n):
        a = 2 * np.pi * k / n
        eye = np.array([2 * np.cos(a), 0.5 + 0.2 * k, 2 * np.sin(a)],
                       np.float32)
        intr = dict(fov=0.6 + 0.1 * k) if lens == "fov" else \
            dict(fov_distance=1.0 + 0.25 * k)
        wrap = jnp.asarray if module is jcam else torch.from_numpy
        out.append(module.Camera.from_args(
            eye=wrap(eye), at=wrap(AT), up=wrap(UP), width=32 + 4 * k,
            height=24, **intr))
    return out


@pytest.mark.parametrize("interp,lens,loop", [
    ("polynomial", "fov", False), ("catmull_rom", "fov", False),
    ("polynomial", "ortho", True), ("catmull_rom", "fov", True)])
def test_camera_paths_match_jax(interp, lens, loop):
    gens = []
    for module in (jcam, tcam):
        ring = _ring(module, 4, lens)
        if loop:
            gen = module.loop_camera_path_generator(ring, 3, interp,
                                                    repeat=1)
        else:
            gen = module.camera_path_generator(ring, 3, interp)
        gens.append(list(itertools.islice(gen, 40)))
    assert len(gens[0]) == len(gens[1]) > 8
    for j, t in zip(*gens):
        assert (t.width, t.height, t.lens_type) == (j.width, j.height,
                                                    j.lens_type)
        close(t.extrinsics.view_matrix(), j.extrinsics.view_matrix())
        close(t.intrinsics.params, j.intrinsics.params, atol=1e-4)
