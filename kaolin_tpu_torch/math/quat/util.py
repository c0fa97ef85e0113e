"""Small math utilities. Counterpart of ``kaolin_tpu/math/quat/util.py``."""

import torch

from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["vector_normalize", "pad_mat33_to_mat44"]


def vector_normalize(vec, eps=1e-12):
    """L2-normalize along the last axis."""
    return vec / clip(torch.linalg.vector_norm(vec, dim=-1, keepdim=True),
                      eps, None)


def pad_mat33_to_mat44(mat33):
    """Embed (..., 3, 3) into homogeneous (..., 4, 4)."""
    out = mat33.new_zeros(tuple(mat33.shape[:-2]) + (4, 4))
    out[..., :3, :3] = mat33
    out[..., 3, 3] = 1.0
    return out
