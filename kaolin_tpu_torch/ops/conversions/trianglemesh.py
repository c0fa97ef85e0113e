"""Mesh → voxel grid and mesh → SPC conversions.

Counterpart of ``kaolin_tpu/ops/conversions/trianglemesh.py``.
``unbatched_mesh_to_spc`` voxelizes a surface by sampling each triangle on
a barycentric lattice finer than a voxel and quantizing the samples. The
lattice's size comes from the host exactly as in the JAX package (numpy
over the (F, 3, 3) faces: a sum taken in another order could move
``ceil(edge · res · 1.5)`` across an integer); the samples are torch ops
on the faces' device in float64, in the JAX package's order (numpy
promotes the float32 faces times the float64 lattice), so the octree is
bit for bit the JAX package's. ``trianglemeshes_to_voxelgrids`` subdivides
on the host in numpy, as there.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions.pointcloud import (
    _base_points_to_voxelgrids,
)
from kaolin_tpu_torch.ops.spc.points import (
    host,
    morton_to_octree,
    morton_to_points,
    points_to_morton,
)

__all__ = ["trianglemeshes_to_voxelgrids", "unbatched_mesh_to_spc"]


def _subdivide_to_resolution(vertices, faces, resolution):
    """Midpoint-subdivide triangles until every edge² is at most
    ((res − 1) / res²)², keeping every vertex made → unique (P, 3) numpy."""
    verts = host(vertices)
    faces_np = host(faces)
    min_edge = ((resolution - 1) / resolution ** 2) ** 2
    v1 = verts[faces_np[:, 0]]
    v2 = verts[faces_np[:, 1]]
    v3 = verts[faces_np[:, 2]]
    all_pts = [verts]
    while True:
        e = np.stack([((v1 - v2) ** 2).sum(1), ((v2 - v3) ** 2).sum(1),
                      ((v3 - v1) ** 2).sum(1)], axis=1)
        keep = e.max(axis=1) > min_edge
        if not keep.any():
            break
        v1, v2, v3 = v1[keep], v2[keep], v3[keep]
        v4 = (v1 + v3) / 2
        v5 = (v1 + v2) / 2
        v6 = (v2 + v3) / 2
        all_pts.extend([v4, v5, v6])
        v1 = np.concatenate([v1, v2, v4, v3])
        v2 = np.concatenate([v4, v5, v5, v4])
        v3 = np.concatenate([v5, v6, v6, v6])
    return np.unique(np.concatenate(all_pts, axis=0), axis=0)


def trianglemeshes_to_voxelgrids(vertices, faces, resolution, origin=None,
                                 scale=None, return_sparse=False):
    """Surface voxelization by vertex upsampling → (B, R, R, R) float32 on
    the vertices' device."""
    if not isinstance(resolution, int):
        raise TypeError(f"expected int resolution, got {type(resolution)}")
    if origin is None:
        origin = torch.amin(vertices, dim=1)
    if scale is None:
        scale = torch.amax(torch.amax(vertices, dim=1) - origin, dim=1)
    batched = (vertices - origin[:, None, :]) / scale.reshape(-1, 1, 1)
    grids = []
    for i in range(vertices.shape[0]):
        pts = _subdivide_to_resolution(batched[i], faces, resolution)
        grids.append(_base_points_to_voxelgrids(
            torch.from_numpy(pts)[None].to(vertices.device), resolution))
    return torch.cat(grids, dim=0)


def unbatched_mesh_to_spc(face_vertices, level):
    """A mesh in [-1, 1] as (F, 3, 3) face vertices → (octree uint8,
    points at the leaf level (P, 3) int16), on the faces' device."""
    fv = host(face_vertices)
    res = 2 ** level
    v1, v2, v3 = fv[:, 0], fv[:, 1], fv[:, 2]
    edge = np.sqrt(max(((v1 - v2) ** 2).sum(1).max(),
                       ((v2 - v3) ** 2).sum(1).max(),
                       ((v3 - v1) ** 2).sum(1).max()))
    n = int(np.clip(np.ceil(edge * res * 1.5), 1, 256))
    # the barycentric lattice, on the host as in the JAX package
    a = np.linspace(0, 1, n + 1)
    u, v = np.meshgrid(a, a)
    mask = (u + v) <= 1.0 + 1e-9
    u, v = u[mask], v[mask]
    w = 1.0 - u - v
    f64 = torch.as_tensor(face_vertices).to(torch.float64)
    u, v, w = (torch.from_numpy(x).to(f64.device)[None, :, None]
               for x in (u, v, w))
    pts = f64[:, None, 0] * u
    pts = pts + f64[:, None, 1] * v
    pts = pts + f64[:, None, 2] * w
    q = torch.floor(torch.clamp((pts.reshape(-1, 3) + 1.0) * (res / 2.0), 0,
                                res - 1)).to(torch.int64)
    del pts
    codes = torch.unique(points_to_morton(q))
    return morton_to_octree(codes, level), morton_to_points(codes)
