"""Triangle-mesh metrics: point → mesh distance, edge length, laplacian
smoothing.

Counterpart of ``kaolin_tpu/metrics/trianglemesh.py``. Distance-type codes:
0 face, 1/2/3 vertex v0/v1/v2, 4 edge01, 5 edge12, 6 edge20.
"""

import torch

from kaolin_tpu_torch.ops.mesh.mesh import faces_on, uniform_laplacian
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "point_to_mesh_distance",
    "average_edge_length",
    "uniform_laplacian_smoothing",
]

_TILE = 512


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _closest_on_tri(points, v1, v2, v3):
    """Squared distance, type code and closest point of each (point,
    triangle) pair; points (..., 3) and v1/v2/v3 (..., 3) broadcast. Where
    regions overlap, the later type's assignment wins, as in the reference's
    naive oracle."""
    e21 = v2 - v1
    e32 = v3 - v2
    e13 = v1 - v3
    normals = -torch.linalg.cross(e21, e13)

    def proj(vert, edge):
        return _dot(points - vert, edge) / clip(_dot(edge, edge), 1e-12, None)

    uab = proj(v1, e21)
    ubc = proj(v2, e32)
    uca = proj(v3, e13)

    def not_above(vert, edge):
        edge_norm = torch.linalg.cross(normals, edge)
        return _dot(edge_norm, points - vert) <= 0

    is1 = (uca > 1.) & (uab < 0.)
    is2 = (uab > 1.) & (ubc < 0.)
    is3 = (ubc > 1.) & (uca < 0.)
    is4 = (uab >= 0.) & (uab <= 1.) & not_above(v1, e21)
    is5 = (ubc >= 0.) & (ubc <= 1.) & not_above(v2, e32)
    is6 = (uca >= 0.) & (uca <= 1.) & not_above(v3, e13)

    unit_n = normals / clip(torch.linalg.vector_norm(normals, dim=-1,
                                                     keepdim=True),
                            1e-12, None)
    plane_pt = points - unit_n * _dot(points - v1, unit_n)[..., None]

    closest = plane_pt
    tcode = torch.zeros(uab.shape, dtype=torch.int32, device=uab.device)
    for cond, pt, code in (
            (is1, v1, 1),
            (is2, v2, 2),
            (is3, v3, 3),
            (is4, v1 + e21 * uab[..., None], 4),
            (is5, v2 + e32 * ubc[..., None], 5),
            (is6, v3 + e13 * uca[..., None], 6)):
        closest = torch.where(cond[..., None], pt, closest)
        tcode = torch.where(cond, code, tcode)
    dist = _dot(closest - points, closest - points)
    return dist, tcode, closest


def _nearest_face(points, face_vertices, tile=_TILE):
    """(N, 3) x (F, 3, 3) → the nearest face's id (N,) int32, ``tile``
    faces at a time; ties go to the lowest id."""
    n, f = points.shape[0], face_vertices.shape[0]
    best_d = torch.full((n,), torch.inf, dtype=points.dtype,
                        device=points.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=points.device)
    p = points[:, None, :]
    for s in range(0, f, tile):
        fv = face_vertices[s:s + tile]
        d, _, _ = _closest_on_tri(p, fv[None, :, 0], fv[None, :, 1],
                                  fv[None, :, 2])
        tmin, targ = d.min(dim=1)
        take = tmin < best_d
        best_d = torch.where(take, tmin, best_d)
        best_i = torch.where(take, targ.to(torch.int32) + s, best_i)
    return best_i


def point_to_mesh_distance(pointclouds, face_vertices):
    """Squared unsigned distance from each point to its nearest triangle.

    Args:
        pointclouds: (B, N, 3).
        face_vertices: (B, F, 3, 3).

    Returns:
        (distance (B, N), face_idx (B, N) int32, dist_type (B, N) int32).
        Differentiable with respect to both inputs, through the nearest
        face only.
    """
    with torch.no_grad():
        idx = torch.stack([_nearest_face(p, fv) for p, fv in
                           zip(pointclouds, face_vertices)])
    sel = torch.take_along_dim(face_vertices, idx.long()[..., None, None],
                               dim=1)
    dist, tcode, _ = _closest_on_tri(pointclouds, sel[..., 0, :],
                                     sel[..., 1, :], sel[..., 2, :])
    return dist, idx, tcode


def average_edge_length(vertices, faces):
    """Mean of each face's three edge lengths → (B, F)."""
    fv = vertices[:, faces_on(faces, vertices.device)]      # (B, F, 3, 3)
    v1, v2, v3 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    norm = torch.linalg.vector_norm
    return (norm(v2 - v1, dim=-1) + norm(v3 - v2, dim=-1)
            + norm(v1 - v3, dim=-1)) / 3.0


def uniform_laplacian_smoothing(vertices, faces):
    """Smoothed vertices (L + I)·V through the uniform laplacian →
    (B, V, 3)."""
    v = vertices.shape[1]
    lap = uniform_laplacian(v, faces, device=vertices.device)
    eye = torch.eye(v, dtype=vertices.dtype, device=vertices.device)
    return torch.einsum("nm,bmc->bnc", lap + eye, vertices)
