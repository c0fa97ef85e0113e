"""Polyscope camera conversions.

Counterpart of ``kaolin_tpu/render/camera/polyscope.py`` (reference
``kaolin/render/camera/polyscope.py``). Both need ``polyscope``'s camera
objects and raise where it is absent, as there.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import host
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["polyscope_camera_to_kaolin", "kaolin_camera_to_polyscope"]


def polyscope_camera_to_kaolin(ps_camera, width, height, near=1e-2, far=1e2,
                               dtype=None, device=None):
    """polyscope.core.CameraParameters → Camera on ``device`` (the CUDA
    device unless one is given). Ref :28."""
    from kaolin_tpu_torch.render.camera.camera import Camera
    device = resolve_device(device, "polyscope_camera_to_kaolin")
    return Camera.from_args(
        view_matrix=torch.as_tensor(np.asarray(ps_camera.get_view_mat())),
        fov=np.deg2rad(ps_camera.get_fov_vertical_deg()),
        width=width, height=height, near=near, far=far, device=device)


def kaolin_camera_to_polyscope(camera):
    """Camera → polyscope.core.CameraParameters (requires polyscope).
    Ref :64."""
    import polyscope as ps
    assert len(camera) == 1, "only single camera supported"
    from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV
    view_matrix = host(camera.view_matrix())
    fov_y = float(host(camera.intrinsics.fov(CameraFOV.VERTICAL))[0])
    return ps.CameraParameters(
        ps.CameraIntrinsics(fov_vertical_deg=fov_y,
                            aspect=camera.width / camera.height),
        ps.CameraExtrinsics(mat=view_matrix[0]))
