"""Camera conversions to/from gaussian-splatting ecosystems.

Counterpart of ``kaolin_tpu/render/camera/gsplats.py`` (reference
``kaolin/render/camera/gsplats_inria.py`` and ``gsplats_nerfstudio.py``):
INRIA gaussian-splatting cameras and nerfstudio-gsplat (Ks/viewmats)
conventions. The conventions differ from kaolin's by a y/z axis flip in
camera space. Tensors come back on the camera's device; the INRIA
parameters are host numpy, as the JAX package gives them.
"""

import math
import warnings

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import host
from kaolin_tpu_torch.render.camera.camera import Camera
from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV

__all__ = [
    "kaolin_camera_to_gsplat_inria",
    "gsplat_inria_camera_to_kaolin",
    "kaolin_camera_to_gsplat_nerfstudio",
    "gsplat_nerfstudio_camera_to_kaolin",
]

_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def kaolin_camera_to_gsplat_inria(kal_camera, gs_cam_cls=None):
    """Camera → INRIA gaussian-splats camera parameters. When ``gs_cam_cls``
    is None, returns a dict of the constructor kwargs instead. Ref
    ``gsplats_inria.py:53``."""
    R = host(kal_camera.extrinsics.R[0]).copy()
    R[1:3] = -R[1:3]
    T = host(kal_camera.extrinsics.t).reshape(-1).copy()
    T[1:3] = -T[1:3]
    kwargs = dict(
        colmap_id=0,
        R=R.T,
        T=T,
        FoVx=float(kal_camera.intrinsics.fov(CameraFOV.HORIZONTAL,
                                             in_degrees=False)[0]),
        FoVy=float(kal_camera.intrinsics.fov(CameraFOV.VERTICAL,
                                             in_degrees=False)[0]),
        image_name="fake",
        uid=0,
    )
    if gs_cam_cls is None:
        return kwargs
    kwargs["image"] = np.zeros((3, kal_camera.height, kal_camera.width))
    kwargs["gt_alpha_mask"] = None
    return gs_cam_cls(**kwargs)


def gsplat_inria_camera_to_kaolin(gs_camera):
    """INRIA gaussian-splats camera → Camera. Accepts either the INRIA class
    or a dict with world_view_transform / image sizes / FoVy.
    Ref ``gsplats_inria.py:88``."""
    if isinstance(gs_camera, dict):
        wvt = gs_camera["world_view_transform"]
        width = gs_camera["image_width"]
        height = gs_camera["image_height"]
        fovy = gs_camera["FoVy"]
    else:
        wvt = gs_camera.world_view_transform
        width = gs_camera.image_width
        height = gs_camera.image_height
        fovy = gs_camera.FoVy
    device = wvt.device if isinstance(wvt, torch.Tensor) else None
    view_mat = host(wvt).T.copy()
    view_mat[1:3] = -view_mat[1:3]
    return Camera.from_args(view_matrix=torch.from_numpy(view_mat)[None],
                            width=width, height=height, fov=float(fovy),
                            device=device)


def kaolin_camera_to_gsplat_nerfstudio(kal_camera):
    """Camera → nerfstudio-gsplat rasterization inputs dict (Ks, viewmats,
    width/height, near/far). Ref ``gsplats_nerfstudio.py:28``."""
    if kal_camera.lens_type != "pinhole":
        raise RuntimeError("only pinhole cameras are supported")
    intr = kal_camera.intrinsics
    c = len(kal_camera)
    K = torch.zeros((c, 3, 3), dtype=intr.focal_x.dtype,
                    device=intr.focal_x.device)
    K[:, 0, 0] = intr.focal_x
    K[:, 1, 1] = intr.focal_y
    K[:, 2, 2] = 1.0
    K[:, 0, 2] = kal_camera.width / 2.0
    K[:, 1, 2] = kal_camera.height / 2.0
    view = kal_camera.extrinsics.view_matrix()
    viewmat = torch.from_numpy(_FLIP_YZ).to(view)[None] @ view
    return {"viewmats": viewmat, "Ks": K, "width": kal_camera.width,
            "height": kal_camera.height, "camera_model": "pinhole",
            "near_plane": intr.near, "far_plane": intr.far}


def gsplat_nerfstudio_camera_to_kaolin(Ks, viewmats, width=None, height=None,
                                       camera_model="pinhole",
                                       near_plane=1e-2, far_plane=1e2):
    """nerfstudio-gsplat (Ks, viewmats) → Camera on the device of
    ``viewmats`` when it is a tensor. Ref ``gsplats_nerfstudio.py:86``."""
    if camera_model != "pinhole":
        raise RuntimeError("only pinhole cameras are supported")
    device = viewmats.device if isinstance(viewmats, torch.Tensor) else None
    Ks = torch.as_tensor(host(Ks))
    viewmats = torch.as_tensor(host(viewmats))
    if Ks.ndim == 2:
        Ks = Ks[None]
    if viewmats.ndim == 2:
        viewmats = viewmats[None]
    if width is None:
        width = int(round(float(Ks[0, 0, 2]) * 2))
    if height is None:
        height = int(round(float(Ks[0, 1, 2]) * 2))
    view = torch.from_numpy(_FLIP_YZ).to(viewmats)[None] @ viewmats
    fovy = 2.0 * math.atan(height / (2.0 * float(Ks[0, 1, 1])))
    return Camera.from_args(view_matrix=view, width=width, height=height,
                            fov=fovy, near=near_plane, far=far_plane,
                            device=device)


def kaolin_camera_to_gsplats(kal_camera, gs_cam_cls=None):
    """Deprecated alias of :func:`kaolin_camera_to_gsplat_inria`."""
    warnings.warn("kaolin_camera_to_gsplats has been renamed "
                  "kaolin_camera_to_gsplat_inria", DeprecationWarning)
    return kaolin_camera_to_gsplat_inria(kal_camera, gs_cam_cls)


def gsplats_camera_to_kaolin(gs_camera):
    """Deprecated alias of :func:`gsplat_inria_camera_to_kaolin`."""
    warnings.warn("gsplats_camera_to_kaolin has been renamed "
                  "gsplat_inria_camera_to_kaolin", DeprecationWarning)
    return gsplat_inria_camera_to_kaolin(gs_camera)
