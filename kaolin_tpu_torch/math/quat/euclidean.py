"""Euclidean (SE(3)) 4x4 transforms. Counterpart of
``kaolin_tpu/math/quat/euclidean.py``."""

import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "euclidean_identity",
    "euclidean_from_rotation_translation",
    "euclidean_rotation_matrix",
    "euclidean_translation_vector",
    "is_euclidean_valid",
    "euclidean_inverse",
]


def _eye4(batch, dtype, device):
    return torch.eye(4, dtype=dtype, device=device).repeat(
        tuple(batch) + (1, 1))


def euclidean_identity(batch_size, dtype=torch.float32, device=None):
    """Identity SE(3) matrices (b, 4, 4), on ``device`` (the CUDA device
    unless another is named)."""
    return _eye4((batch_size,), dtype,
                 resolve_device(device, "euclidean_identity"))


def euclidean_from_rotation_translation(r=None, t=None):
    """(b, 4, 4) from a rotation (b, 3, 3) and/or a translation (b, 3)."""
    if r is None and t is None:
        raise ValueError("need rotation or translation")
    like = r if r is not None else t
    batch = r.shape[:-2] if r is not None else t.shape[:-1]
    out = _eye4(batch, like.dtype, like.device)
    if r is not None:
        out[..., :3, :3] = r
    if t is not None:
        out[..., :3, 3] = t
    return out


def euclidean_rotation_matrix(x):
    """The rotation block."""
    return x[..., :3, :3]


def euclidean_translation_vector(x):
    """The translation column."""
    return x[..., :3, 3]


def is_euclidean_valid(x, throw=False):
    """The bottom row is [0, 0, 0, 1] and the rotation orthonormal."""
    bottom = torch.allclose(
        x[..., 3, :], torch.tensor([0, 0, 0, 1], dtype=x.dtype,
                                   device=x.device).expand_as(x[..., 3, :]),
        atol=1e-5)
    r = x[..., :3, :3]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    ortho = torch.allclose(r @ r.transpose(-1, -2), eye.expand_as(r),
                           atol=1e-4)
    ok = bool(bottom) and bool(ortho)
    if throw and not ok:
        raise ValueError("invalid euclidean transform")
    return ok


def euclidean_inverse(x):
    """Closed-form SE(3) inverse."""
    r = x[..., :3, :3]
    t = x[..., :3, 3]
    rt = r.transpose(-1, -2)
    out = _eye4(x.shape[:-2], x.dtype, x.device)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", rt, t)
    return out
