"""3x3 rotation matrices. Counterpart of
``kaolin_tpu/math/quat/rotation33.py``."""

import torch

from kaolin_tpu_torch.utils.backend import resolve_device
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "is_rot33_valid",
    "rot33_identity",
    "translation_identity",
    "rot33_inverse",
    "rot33_rotate",
    "rot33_from_quat",
    "rot33_from_angle_axis",
]


def is_rot33_valid(rot33, atol=1e-6):
    """Orthonormal with determinant +1."""
    eye = torch.eye(3, dtype=rot33.dtype, device=rot33.device)
    ortho = torch.allclose(rot33 @ rot33.transpose(-1, -2),
                           eye.expand_as(rot33), atol=atol)
    det = torch.linalg.det(rot33)
    return bool(ortho) and bool(torch.allclose(det, torch.ones_like(det),
                                               atol=atol))


def rot33_identity(batch_size=1, dtype=torch.float32, device=None):
    """Identity rotations (b, 3, 3), on ``device`` (the CUDA device unless
    another is named)."""
    device = resolve_device(device, "rot33_identity")
    return torch.eye(3, dtype=dtype, device=device).expand(batch_size, 3, 3)


def translation_identity(batch_size=1, dtype=torch.float32, device=None):
    """Zero translations (b, 3), on ``device`` (the CUDA device unless
    another is named)."""
    device = resolve_device(device, "translation_identity")
    return torch.zeros((batch_size, 3), dtype=dtype, device=device)


def rot33_inverse(mat):
    """The transpose."""
    return mat.transpose(-1, -2)


def rot33_rotate(point, mat):
    """Rotate point(s) (..., 3) by matrix (..., 3, 3)."""
    return torch.einsum("...ij,...j->...i", mat, point)


def rot33_from_quat(quat):
    """Unit quaternion (x, y, z, w) → rotation matrix (..., 3, 3)."""
    x, y, z, w = torch.unbind(quat, -1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot33_from_angle_axis(angle, axis):
    """Rodrigues' formula: (angle (..., 1), axis (..., 3)) → (..., 3, 3)."""
    axis = axis / clip(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                       1e-12, None)
    x, y, z = torch.unbind(axis, -1)
    c = torch.cos(angle[..., 0])
    s = torch.sin(angle[..., 0])
    t = 1.0 - c
    row0 = torch.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                       -1)
    row1 = torch.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                       -1)
    row2 = torch.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c],
                       -1)
    return torch.stack([row0, row1, row2], dim=-2)
