"""Angle-axis conversions. Counterpart of
``kaolin_tpu/math/quat/angle_axis.py``."""

import torch

from kaolin_tpu_torch.math.quat.quaternion import (
    quat_from_rot33,
    quat_unit_positive,
)
from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["angle_axis_from_quat", "angle_axis_from_rot33"]


def angle_axis_from_quat(quat):
    """Unit quaternion → (angle (..., 1), axis (..., 3)); the x axis where
    the rotation is the identity."""
    q = quat_unit_positive(quat)
    w = clip(q[..., 3:], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt(clip(1.0 - w * w, 1e-12, None))
    default_axis = torch.zeros_like(q[..., :3])
    default_axis[..., 0] = 1.0
    axis = torch.where(s > 1e-6, q[..., :3] / s, default_axis)
    return angle, axis


def angle_axis_from_rot33(mat):
    """Rotation matrix → (angle, axis)."""
    return angle_axis_from_quat(quat_from_rot33(mat))
