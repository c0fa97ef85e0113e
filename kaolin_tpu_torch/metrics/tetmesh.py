"""Tetrahedral-mesh quality metrics. Counterpart of
``kaolin_tpu/metrics/tetmesh.py`` (reference ``kaolin/metrics/tetmesh.py``).

:func:`equivolume` subtracts each item's own mean volume: the JAX package
(and the reference) reshape the means to (1, B), which at B > 1 subtracts
every item's mean from every item (fault F21)."""

import torch

__all__ = ["tetrahedron_volume", "equivolume", "amips"]


def _validate(tet_vertices):
    if tet_vertices.ndim != 4 or tuple(tet_vertices.shape[-2:]) != (4, 3):
        raise ValueError(f"expected (B, T, 4, 3), got "
                         f"{tuple(tet_vertices.shape)}")


def tetrahedron_volume(tet_vertices):
    """Signed volume of batched tets (B, T, 4, 3) → (B, T)."""
    _validate(tet_vertices)
    a, b, c, d = (tet_vertices[..., i, :] for i in range(4))
    return ((a - d) * torch.linalg.cross(b - d, c - d)).sum(-1) / 6.0


def equivolume(tet_vertices, tetrahedrons_mean=None, pow=4):
    """DefTet EquiVolume loss → (B, 1): the mean of |volume − mean|^pow over
    each item's tets, the mean being the item's own (or
    ``tetrahedrons_mean``, one value or one an item)."""
    _validate(tet_vertices)
    volumes = tetrahedron_volume(tet_vertices)
    if tetrahedrons_mean is None:
        tetrahedrons_mean = volumes.mean(dim=-1)
    tetrahedrons_mean = torch.as_tensor(
        tetrahedrons_mean, dtype=volumes.dtype,
        device=volumes.device).reshape(-1, 1)
    return ((volumes - tetrahedrons_mean).abs() ** pow).mean(dim=-1,
                                                            keepdim=True)


def amips(tet_vertices, inverse_offset_matrix):
    """AMIPS energy over the tets with a non-negative Jacobian determinant
    → (B, 1)."""
    _validate(tet_vertices)
    a = tet_vertices[..., 0:1, :]
    offset = torch.cat([tet_vertices[..., 1:2, :] - a,
                        tet_vertices[..., 2:3, :] - a,
                        tet_vertices[..., 3:4, :] - a], dim=-2)
    jac = offset @ inverse_offset_matrix
    j_det = torch.linalg.det(jac)
    trace = (jac @ jac.transpose(-1, -2)).diagonal(dim1=-2, dim2=-1).sum(-1)
    denominator = (j_det ** 2 + 1e-10) ** (1.0 / 3.0)
    return ((trace / denominator) * (j_det >= 0).to(trace.dtype)).mean(
        dim=1, keepdim=True)
