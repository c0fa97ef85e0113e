"""Point-in-mesh test by ray-parity counting, in PyTorch.

Counterpart of ``kaolin_tpu/ops/mesh/check_sign.py``. A ray goes from each
query point along +z; a point is inside when the ray crosses the surface an
odd number of times. The 2D point-in-triangle test in xy keeps only
strictly positive or strictly negative edge functions, so a ray through a
shared edge is counted by neither face, as in the JAX package.

The faces are taken a tile at a time, so memory stays O(N · tile).
"""

import numpy as np
import torch

__all__ = ["check_sign"]

# elements of one (points, faces) tile: the tile's faces are as many as
# keep each temporary at 2^23 floats (32 MB), at most 1,024
_TILE_ELEMENTS = 1 << 23
_MAX_TILE = 1024


def _crossings(p, tri):
    """+z-ray crossings of points p (N, 3) with triangles tri (T, 3, 3) →
    (N,) int32."""
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    px, py = p[:, None, 0], p[:, None, 1]

    def edge(a, b):
        return ((b[None, :, 0] - a[None, :, 0]) * (py - a[None, :, 1])
                - (b[None, :, 1] - a[None, :, 1]) * (px - a[None, :, 0]))

    e0, e1, e2 = edge(v0, v1), edge(v1, v2), edge(v2, v0)
    inside = (((e0 > 0) & (e1 > 0) & (e2 > 0))
              | ((e0 < 0) & (e1 < 0) & (e2 < 0)))
    # the barycentric z at (px, py); e1 belongs to v0, e2 to v1
    area = e0 + e1 + e2
    area = torch.where(area.abs() > 1e-12, area, torch.ones_like(area))
    w0 = e1 / area
    w1 = e2 / area
    w2 = 1.0 - w0 - w1
    z = w0 * v0[None, :, 2] + w1 * v1[None, :, 2] + w2 * v2[None, :, 2]
    hit = inside & (z > p[:, None, 2])
    return hit.sum(dim=1, dtype=torch.int32)


def _unbatched_check_sign(verts, faces, points):
    fv = verts[faces]                                   # (F, 3, 3)
    n = points.shape[0]
    tile = max(1, min(_MAX_TILE, _TILE_ELEMENTS // max(n, 1)))
    count = torch.zeros((n,), dtype=torch.int32, device=points.device)
    for start in range(0, fv.shape[0], tile):
        count += _crossings(points, fv[start:start + tile])
    return (count % 2) == 1


def check_sign(verts, faces, points, hash_resolution=512, backend=None):
    """True for the points inside a watertight mesh.

    Args:
        verts: (B, V, 3) tensor.
        faces: (F, 3) integer tensor.
        points: (B, N, 3) tensor on the vertices' device.
        hash_resolution: the grid size of the native TriangleHash backend
            (at most 1,024 is used, as in the JAX package).
        backend: None, the ray-parity test in PyTorch on the tensors'
            device; or ``"native"``, the C++ TriangleHash of
            :mod:`kaolin_tpu_torch.native` on the host: the normalised
            tensors are copied to the host and the answer back to the
            points' device. Without the library it raises RuntimeError;
            nothing falls back.

    Returns:
        (B, N) bool on the points' device.
    """
    if backend not in (None, "native"):
        raise ValueError(f"unknown backend {backend!r}")
    faces = torch.as_tensor(faces, device=verts.device).long()
    # normalise by the largest box side of each mesh
    extent = verts.amax(dim=1) - verts.amin(dim=1)       # (B, 3)
    maxlen = extent.amax(dim=-1)[:, None, None]
    verts = verts / maxlen
    points = points / maxlen
    if backend == "native":
        from kaolin_tpu_torch import native
        faces_np = faces.cpu().numpy()
        out = [native.check_sign_cpu(v.detach().cpu().numpy(), faces_np,
                                     p.detach().cpu().numpy(),
                                     resolution=min(hash_resolution, 1024))
               for v, p in zip(verts, points)]
        return torch.from_numpy(np.stack(out)).to(points.device)
    return torch.stack([_unbatched_check_sign(v, faces, p)
                        for v, p in zip(verts, points)])
