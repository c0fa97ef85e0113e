"""Material parameter helpers, in PyTorch.

Counterpart of ``kaolin_tpu/physics/materials/material_utils.py``: closed-form
batched 3x3 determinant, adjugate and inverse (a handful of elementwise ops
over the batch instead of a batched LU), Lamé parameters and deformation
gradients from reduced DOFs.
"""

import torch

__all__ = ["to_lame", "get_defo_grad", "det_3x3", "adjugate_3x3", "inv_3x3"]


def det_3x3(m):
    """Batched 3x3 determinant by cofactor expansion, (..., 3, 3) → (...)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def adjugate_3x3(m):
    """Batched 3x3 adjugate (the transposed cofactor matrix)."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    rows = [torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1)]
    return torch.stack(rows, dim=-2)


def inv_3x3(m, det=None):
    """Batched 3x3 inverse through the adjugate; ``det`` (...) may be
    passed in to share the determinant."""
    if det is None:
        det = det_3x3(m)
    return adjugate_3x3(m) / det[..., None, None]


def to_lame(yms, prs):
    """Young's modulus and Poisson ratio → Lamé (mu, lambda)."""
    mus = yms / (2 * (1 + prs))
    lams = yms * prs / ((1 + prs) * (1 - 2 * prs))
    return mus, lams


def get_defo_grad(z, dFdz):
    """Deformation gradients F = reshape(dFdz @ z) + I → (N, 3, 3), from
    z (12H,) and the dense dFdz (9N, 12H)."""
    Fs = (dFdz @ z).reshape(-1, 3, 3)
    return Fs + torch.eye(3, dtype=Fs.dtype, device=Fs.device)
