"""Legacy camera functions (the DIB-R-era API). Counterpart of
``kaolin_tpu/render/camera/legacy.py``."""

import math

import torch

__all__ = [
    "rotate_translate_points",
    "generate_rotate_translate_matrices",
    "generate_transformation_matrix",
    "perspective_camera",
    "generate_perspective_projection",
]


def _unit(x, eps=0.0):
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + eps)


def rotate_translate_points(points, camera_rot, camera_trans):
    """P_new = R (P_old − T): points (B, N, 3), camera_rot (B, 3, 3),
    camera_trans (B, 3) or (B, 3, 1)."""
    translated = points - camera_trans.reshape(-1, 1, 3)
    return torch.matmul(translated, camera_rot.transpose(-1, -2))


def generate_rotate_translate_matrices(camera_position, look_at,
                                       camera_up_direction):
    """(rot (B, 3, 3), trans (B, 3)) such that P_cam = R (P_world − T)."""
    camz = _unit(look_at - camera_position, 1e-10)
    camera_up_direction = camera_up_direction.expand_as(camz)
    camx = _unit(torch.linalg.cross(camz, camera_up_direction), 1e-10)
    camy = _unit(torch.linalg.cross(camx, camz), 1e-10)
    mtx = torch.stack([camx, camy, -camz], dim=1)
    return mtx, camera_position


def generate_transformation_matrix(camera_position, look_at,
                                   camera_up_direction):
    """(B, 4, 3) M such that P_cam = [P_world, 1] @ M."""
    z_axis = _unit(camera_position - look_at)
    camera_up_direction = camera_up_direction.expand_as(z_axis)
    x_axis = _unit(torch.linalg.cross(camera_up_direction, z_axis))
    y_axis = torch.linalg.cross(z_axis, x_axis)
    rot_part = torch.stack([x_axis, y_axis, z_axis], dim=2)
    trans_part = torch.matmul(-camera_position[:, None, :], rot_part)
    return torch.cat([rot_part, trans_part], dim=1)


def perspective_camera(points, camera_proj):
    """Project camera-space points (B, N, 3) with a (3, 1) projection
    vector → image-plane points (B, N, 2)."""
    projected = points * camera_proj.reshape(-1, 1, 3)
    return projected[:, :, :2] / projected[:, :, 2:3]


def generate_perspective_projection(fovyangle, ratio=1.0,
                                    dtype=torch.float32, device="cpu"):
    """The (3, 1) projection vector of a vertical field of view
    ``fovyangle`` (radians)."""
    tanfov = math.tan(fovyangle / 2.0)
    return torch.tensor([[1.0 / (ratio * tanfov)], [1.0 / tanfov], [-1.0]],
                        dtype=dtype, device=device)
