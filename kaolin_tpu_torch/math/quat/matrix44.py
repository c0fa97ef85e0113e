"""4x4 homogeneous matrices. Counterpart of
``kaolin_tpu/math/quat/matrix44.py``."""

import torch

from kaolin_tpu_torch.math.quat.rotation33 import rot33_from_quat

__all__ = ["rot44_from_quat", "translation_to_mat44", "scale_to_mat44"]


def rot44_from_quat(quat):
    """Quaternion → homogeneous 4x4 rotation."""
    r = rot33_from_quat(quat)
    out = r.new_zeros(tuple(r.shape[:-2]) + (4, 4))
    out[..., :3, :3] = r
    out[..., 3, 3] = 1.0
    return out


def translation_to_mat44(vec):
    """Translation (..., 3) → homogeneous 4x4."""
    out = torch.eye(4, dtype=vec.dtype, device=vec.device).repeat(
        tuple(vec.shape[:-1]) + (1, 1))
    out[..., :3, 3] = vec
    return out


def scale_to_mat44(scale):
    """Per-axis scale (..., 3) → homogeneous 4x4."""
    out = scale.new_zeros(tuple(scale.shape[:-1]) + (4, 4))
    for i in range(3):
        out[..., i, i] = scale[..., i]
    out[..., 3, 3] = 1.0
    return out
