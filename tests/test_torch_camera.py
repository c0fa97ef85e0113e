"""kaolin_tpu_torch cameras against kaolin_tpu's, on the CPU.

The same numpy eyes, targets and matrices go to both packages. Rotations,
translations, view matrices, transforms and rays agree within 1e-6: the two
packages take norms and cross products with different summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render.camera import Camera as CameraJax
from kaolin_tpu.render.camera import CameraExtrinsics as CameraExtrinsicsJax
from kaolin_tpu.render.camera import CameraFOV as CameraFOVJax
from kaolin_tpu.render.camera.raygen import generate_rays as generate_rays_jax
from kaolin_tpu_torch.render.camera import (
    Camera,
    CameraExtrinsics,
    CameraFOV,
    OrthographicIntrinsics,
    PinholeIntrinsics,
    generate_rays,
)
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

ATOL = 1e-6
EYES = [[1.4, 1.0, 1.3], [0.1, 2.0, 0.1], [-1.8, -0.4, 0.6],
        [0.05, 0.02, 0.04]]
LENSES = {"fov": {"fov": 0.9}, "focal": {"focal_x": 40.0, "focal_y": 30.0},
          "ortho": {"fov_distance": 1.5}}


def close(port, jax_value):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_value),
                               rtol=0, atol=ATOL)


def lookat_pair(eye, lens, width=40, height=24):
    args = dict(width=width, height=height, **LENSES[lens])
    jcam = CameraJax.from_args(eye=jnp.asarray(eye, jnp.float32),
                               at=jnp.asarray([0.1, 0.0, -0.2], jnp.float32),
                               up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                               **args)
    tcam = Camera.from_args(eye=torch.tensor(eye), at=torch.tensor(
        [0.1, 0.0, -0.2]), up=torch.tensor([0.0, 1.0, 0.0]), **args)
    return jcam, tcam


@pytest.mark.parametrize("lens", sorted(LENSES))
@pytest.mark.parametrize("eye", EYES)
def test_lookat_camera_matches_jax(eye, lens):
    jcam, tcam = lookat_pair(eye, lens)
    assert tcam.lens_type == jcam.lens_type
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height)
    assert tcam.dtype == torch.float32
    close(tcam.extrinsics.R, jcam.extrinsics.R)
    close(tcam.extrinsics.t, jcam.extrinsics.t)
    close(tcam.extrinsics.view_matrix(), jcam.extrinsics.view_matrix())
    close(tcam.extrinsics.inv_view_matrix(),
          jcam.extrinsics.inv_view_matrix())
    close(tcam.extrinsics.cam_pos(), jcam.extrinsics.cam_pos())
    close(tcam.intrinsics.params, jcam.intrinsics.params)

    pts = np.random.RandomState(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    close(tcam.extrinsics.transform(torch.from_numpy(pts)),
          jcam.extrinsics.transform(jnp.asarray(pts)))
    close(tcam.transform(torch.from_numpy(pts)),
          jcam.transform(jnp.asarray(pts)))

    ot, dt = tcam.generate_rays()
    oj, dj = generate_rays_jax(jcam)
    assert ot.shape == (40 * 24, 3) and dt.shape == (40 * 24, 3)
    close(ot, oj)
    close(dt, dj)
    close(generate_rays(tcam)[1], dj)


@pytest.mark.parametrize("direction", list(CameraFOV))
def test_tan_half_fov_and_params(direction):
    jcam, tcam = lookat_pair(EYES[0], "focal")
    close(tcam.intrinsics.tan_half_fov(direction),
          jcam.intrinsics.tan_half_fov(CameraFOVJax[direction.name]))
    for name in ("x0", "y0", "focal_x", "focal_y"):
        close(getattr(tcam, name), getattr(jcam, name))
    tp = PinholeIntrinsics.from_fov(32, 16, 0.7, CameraFOV.HORIZONTAL,
                                   device="cpu")
    assert tp.params.shape == (1, 4)
    to = OrthographicIntrinsics.from_frustum(32, 16, 2.0, num_cameras=3,
                                             device="cpu")
    assert to.params.shape == (3, 1) and to.lens_type == "ortho"


def test_view_matrix_and_pose_constructors_match_jax():
    jcam, _ = lookat_pair(EYES[2], "fov")
    view = np.array(jcam.extrinsics.view_matrix())
    tcam = Camera.from_args(view_matrix=torch.from_numpy(view), focal_x=30.0,
                            width=40, height=24)
    jcam2 = CameraJax.from_args(view_matrix=jnp.asarray(view), focal_x=30.0,
                                width=40, height=24)
    close(tcam.extrinsics.R, jcam2.extrinsics.R)
    close(tcam.extrinsics.t, jcam2.extrinsics.t)
    close(tcam.generate_rays()[1], generate_rays_jax(jcam2)[1])

    pos = np.array([[0.5, 1.5, -2.0]], np.float32)
    rot = np.array(jcam.extrinsics.R)
    te = CameraExtrinsics.from_camera_pose(torch.from_numpy(pos),
                                           torch.from_numpy(rot))
    je = CameraExtrinsicsJax.from_camera_pose(jnp.asarray(pos),
                                              jnp.asarray(rot))
    close(te.R, je.R)
    close(te.t, je.t)
    close(te.cam_pos(), je.cam_pos())
    o, d = te.inv_transform_rays(torch.zeros(5, 3), torch.ones(5, 3))
    oj, dj = je.inv_transform_rays(jnp.zeros((5, 3)), jnp.ones((5, 3)))
    close(o, oj)
    close(d, dj)


def test_from_args_rejects_bad_arguments():
    with pytest.raises(ValueError):
        Camera.from_args(width=8, height=8, fov=0.5)
    with pytest.raises(TypeError):
        Camera.from_args(eye=[1.0, 1.0, 1.0], at=[0.0, 0.0, 0.0],
                         up=[0.0, 1.0, 0.0], fov=0.5, width=8, height=8,
                         device="cpu", nonsense=1)
