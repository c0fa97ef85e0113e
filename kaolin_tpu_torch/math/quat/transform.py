"""Rigid transforms as (quaternion, translation) (..., 7), laid out
``(x, y, z, w, tx, ty, tz)``. Counterpart of
``kaolin_tpu/math/quat/transform.py``."""

import torch

from kaolin_tpu_torch.math.quat.euclidean import (
    euclidean_rotation_matrix,
    euclidean_translation_vector,
)
from kaolin_tpu_torch.math.quat.quaternion import (
    quat_from_rot33,
    quat_identity,
    quat_inverse,
    quat_mul,
    quat_rotate,
    quat_unit_positive,
)
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "transform_from_rotation_translation",
    "transform_from_euclidean",
    "transform_identity",
    "transform_rotation",
    "transform_translation",
    "transform_inverse",
    "transform_mul",
    "transform_apply",
]


def transform_from_rotation_translation(rotation=None, translation=None):
    """Quaternion (..., 4) + translation (..., 3) → transform (..., 7)."""
    if rotation is None and translation is None:
        raise ValueError("need rotation or translation")
    if rotation is None:
        rotation = quat_identity(translation.shape[:-1],
                                 dtype=translation.dtype,
                                 device=translation.device)
    if translation is None:
        translation = rotation.new_zeros(tuple(rotation.shape[:-1]) + (3,))
    return torch.cat([rotation, translation], dim=-1)


def transform_from_euclidean(euclidean):
    """SE(3) 4x4 → transform (..., 7)."""
    return transform_from_rotation_translation(
        quat_from_rot33(euclidean_rotation_matrix(euclidean)),
        euclidean_translation_vector(euclidean))


def transform_identity(shape, dtype=torch.float32, device=None):
    """Identity transforms (*shape, 7), on ``device`` (the CUDA device
    unless another is named)."""
    if isinstance(shape, int):
        shape = (shape,)
    device = resolve_device(device, "transform_identity")
    return torch.cat([quat_identity(shape, dtype=dtype, device=device),
                      torch.zeros(tuple(shape) + (3,), dtype=dtype,
                                  device=device)], dim=-1)


def transform_rotation(x):
    """The quaternion part."""
    return x[..., :4]


def transform_translation(x):
    """The translation part."""
    return x[..., 4:]


def transform_inverse(x):
    """The inverse rigid transform."""
    qinv = quat_unit_positive(quat_inverse(transform_rotation(x)))
    t = -quat_rotate(qinv, transform_translation(x))
    return torch.cat([qinv, t], dim=-1)


def transform_mul(x, y):
    """Compose: apply y, then x."""
    qx, tx = transform_rotation(x), transform_translation(x)
    qy, ty = transform_rotation(y), transform_translation(y)
    q = quat_unit_positive(quat_mul(qx, qy))
    t = quat_rotate(qx, ty) + tx
    return torch.cat([q, t], dim=-1)


def transform_apply(transform, point):
    """Apply to 3D point(s)."""
    return quat_rotate(transform_rotation(transform), point) \
        + transform_translation(transform)
