"""Point cloud conversions.

Counterpart of ``kaolin_tpu/ops/conversions/pointcloud.py``:
occupancy grids by a scatter-max on the points' device, and the SPC of a
point cloud built on the host in numpy, as in the JAX package.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import (
    device_of,
    host,
    morton_to_octree,
    points_to_morton,
    quantize_points,
)

__all__ = ["pointclouds_to_voxelgrids", "unbatched_pointcloud_to_spc"]


def _base_points_to_voxelgrids(pointclouds, resolution):
    """Normalized [0, 1] points (B, N, 3) → binary occupancy grids (B, R,
    R, R) float32: a point lands in ``round(p · (R − 1))`` (half to even)
    and counts only where that index lies in [0, R − 1]."""
    b, n, _ = pointclouds.shape
    coords = torch.round(pointclouds * (resolution - 1)).to(torch.int64)
    in_range = torch.all((coords >= 0) & (coords <= resolution - 1), dim=-1)
    coords = torch.clamp(coords, 0, resolution - 1)
    bidx = torch.arange(b, device=coords.device).repeat_interleave(n)
    flat = coords.reshape(-1, 3)
    index = ((bidx * resolution + flat[:, 0]) * resolution
             + flat[:, 1]) * resolution + flat[:, 2]
    vg = torch.zeros(b * resolution ** 3, dtype=torch.float32,
                     device=coords.device)
    vg = vg.scatter_reduce(0, index, in_range.reshape(-1).to(torch.float32),
                           "amax")
    return vg.reshape(b, resolution, resolution, resolution)


def pointclouds_to_voxelgrids(pointclouds, resolution, origin=None, scale=None,
                              return_sparse=False):
    """(B, N, 3) points → (B, R, R, R) binary occupancy.
    ``return_sparse`` is taken for the API's sake (the output is dense)."""
    if not isinstance(resolution, int):
        raise TypeError(f"expected int resolution, got {type(resolution)}")
    if origin is None:
        origin = torch.amin(pointclouds, dim=1)
    if scale is None:
        scale = torch.amax(torch.amax(pointclouds, dim=1) - origin, dim=1)
    normalized = (pointclouds - origin[:, None, :]) / scale.reshape(-1, 1, 1)
    return _base_points_to_voxelgrids(normalized, resolution)


def unbatched_pointcloud_to_spc(pointcloud, level, features=None,
                                device=None):
    """An unbatched [-1, 1] point cloud → Spc (batch of one) on ``device``,
    else where the cloud or the features lie, else on the card, with
    ``features`` of the points in one cell averaged (rounded for integer
    features) as ``spc.features``."""
    from kaolin_tpu_torch.rep.spc import Spc

    device = device_of(pointcloud, device, features)
    points = host(quantize_points(torch.as_tensor(pointcloud), level))
    unique, unique_keys, unique_counts = np.unique(
        points, axis=0, return_inverse=True, return_counts=True)
    unique_keys = unique_keys.reshape(-1)
    codes = points_to_morton(unique, "cpu").numpy()
    order = np.argsort(codes)
    octree = morton_to_octree(codes, level, device=device)
    feat = None
    if features is not None:
        feats_np = host(features)
        acc = np.zeros((unique.shape[0], feats_np.shape[1]))
        np.add.at(acc, unique_keys, feats_np.astype(np.float64))
        acc /= unique_counts[:, None]
        if not np.issubdtype(feats_np.dtype, np.floating):
            acc = np.round(acc)
        feat = torch.from_numpy(acc[order].astype(feats_np.dtype)).to(
            device)
    spc = Spc(octrees=octree, lengths=torch.tensor([len(octree)],
                                                   dtype=torch.int32,
                                                   device=device))
    spc.features = feat
    return spc
