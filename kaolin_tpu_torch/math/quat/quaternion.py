"""Quaternions in PyTorch. Counterpart of
``kaolin_tpu/math/quat/quaternion.py``: the layout is ``(x, y, z, w)``,
the real part last; every function broadcasts over leading batch dims."""

import torch

from kaolin_tpu_torch.utils.backend import resolve_device
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "quat_real",
    "quat_imaginary",
    "quat_positive",
    "quat_abs",
    "quat_unit",
    "quat_unit_positive",
    "quat_identity",
    "quat_conjugate",
    "quat_inverse",
    "quat_mul",
    "quat_rotate",
    "quat_from_angle_axis",
    "quat_from_rot33",
]

_EPS = 1e-12


def quat_real(quat):
    """Real (w) component, shape (..., 1)."""
    return quat[..., 3:]


def quat_imaginary(quat):
    """Imaginary (xyz) components, shape (..., 3)."""
    return quat[..., :3]


def quat_positive(quat):
    """Flip the sign so the real component is non-negative."""
    return torch.where(quat[..., 3:] < 0, -quat, quat)


def quat_abs(quat):
    """Quaternion norm, shape (..., 1)."""
    return torch.linalg.vector_norm(quat, dim=-1, keepdim=True)


def quat_unit(quat):
    """Normalize to unit norm."""
    return quat / clip(quat_abs(quat), _EPS, None)


def quat_unit_positive(quat):
    """Unit norm with a non-negative real part (one quaternion a
    rotation)."""
    return quat_unit(quat_positive(quat))


def quat_identity(shape, dtype=torch.float32, device=None):
    """Identity quaternion(s) of shape (*shape, 4), on ``device`` (the CUDA
    device unless another is named)."""
    if isinstance(shape, int):
        shape = (shape,)
    device = resolve_device(device, "quat_identity")
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_conjugate(quat):
    """(−x, −y, −z, w)."""
    return torch.cat([-quat[..., :3], quat[..., 3:]], dim=-1)


def quat_inverse(quat):
    """Inverse: conjugate / |q|²."""
    return quat_conjugate(quat) / clip(
        torch.sum(quat * quat, dim=-1, keepdim=True), _EPS, None)


def quat_mul(a, b):
    """Hamilton product a·b."""
    x1, y1, z1, w1 = torch.unbind(a, -1)
    x2, y2, z2, w2 = torch.unbind(b, -1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2
    z = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2
    return torch.stack([x, y, z, w], dim=-1)


def quat_rotate(rotation, point):
    """Rotate 3D point(s) by unit quaternion(s): q p q*."""
    pq = torch.cat([point, torch.zeros_like(point[..., :1])], dim=-1)
    return quat_imaginary(quat_mul(quat_mul(rotation, pq),
                                   quat_conjugate(rotation)))


def quat_from_angle_axis(angle, axis, is_degree=False):
    """(angle (..., 1), axis (..., 3)) → quaternion (..., 4)."""
    radians = torch.deg2rad(angle) if is_degree else angle
    half = 0.5 * radians
    axis_n = axis / clip(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                         _EPS, None)
    return torch.cat([torch.sin(half) * axis_n, torch.cos(half)], dim=-1)


def quat_from_rot33(mat):
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4) with a
    non-negative real part: Shepperd's method, its four cases chosen with
    ``torch.where`` as the JAX package does."""
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(clip(x, _EPS, None))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                      0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return quat_unit_positive(q)
