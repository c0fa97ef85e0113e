"""SPC point utilities: quantization, Morton codes, octree construction and
cell corners.

Counterpart of ``kaolin_tpu/ops/spc/points.py``. Morton convention: (x, y,
z) interleaved with z in the least significant bit of each triplet, so
[0, 0, 1] → 1, [0, 1, 0] → 2, [1, 0, 0] → 4.

Morton codes and octree construction run on the host in numpy, as in the
JAX package: the octree has a variable length and is built once per asset.
Each returns a tensor on ``device``; where it is None, on the device of the
input when that is a tensor, else on the CPU.
"""

import numpy as np
import torch

__all__ = [
    "quantize_points",
    "points_to_morton",
    "morton_to_points",
    "unbatched_points_to_octree",
    "morton_to_octree",
    "points_to_corners",
]


def host(x):
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_of(x, device):
    """``device`` if given, else the device of ``x`` when it is a tensor,
    else the CPU."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _spread_bits_np(x):
    """Spread 16-bit ints so bits occupy every third position (int64)."""
    x = x.astype(np.int64) & 0xFFFF
    x = (x | (x << 16)) & 0x0000FF0000FF
    x = (x | (x << 8)) & 0x00F00F00F00F
    x = (x | (x << 4)) & 0x0C30C30C30C3
    x = (x | (x << 2)) & 0x249249249249
    return x


def _compact_bits_np(x):
    x = x.astype(np.int64) & 0x249249249249
    x = (x | (x >> 2)) & 0x0C30C30C30C3
    x = (x | (x >> 4)) & 0x00F00F00F00F
    x = (x | (x >> 8)) & 0x0000FF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def _morton_np(pts):
    pts = pts.reshape(-1, 3).astype(np.int64)
    return (_spread_bits_np(pts[:, 0]) << 2 | _spread_bits_np(pts[:, 1]) << 1
            | _spread_bits_np(pts[:, 2]))


def quantize_points(x, level):
    """[-1, 1] floats → int16 grid coords in [0, 2^level − 1]."""
    res = 2 ** level
    return torch.floor(torch.clamp(res * (x + 1.0) / 2.0, 0, res - 1.0)).to(
        torch.int16)


def points_to_morton(points, device=None):
    """(..., 3) int coords → (...,) int64 Morton codes."""
    pts = host(points)
    m = _morton_np(pts).reshape(pts.shape[:-1])
    return torch.from_numpy(m).to(device_of(points, device))


def morton_to_points(morton, device=None):
    """(...,) Morton codes → (..., 3) int16 coords."""
    m = host(morton).astype(np.int64)
    flat = m.reshape(-1)
    pts = np.stack([_compact_bits_np(flat >> 2), _compact_bits_np(flat >> 1),
                    _compact_bits_np(flat)], axis=-1)
    return torch.from_numpy(pts.astype(np.int16).reshape(m.shape + (3,))).to(
        device_of(morton, device))


def unbatched_points_to_octree(points, level, sorted=False, device=None):
    """Quantized points (N, 3) at ``level`` → byte-packed octree, uint8.

    ``sorted=True`` says the points are already unique: their codes are
    sorted but not deduplicated."""
    m = _morton_np(host(points))
    m = np.sort(m) if sorted else np.unique(m)
    octree_levels = []
    for _ in range(level, 0, -1):
        parent = m >> 3
        octant = m & 7
        # group children by parent (m sorted → parents sorted)
        uniq_parent = np.unique(parent)
        bytes_l = np.zeros(uniq_parent.shape[0], dtype=np.uint8)
        np.bitwise_or.at(bytes_l, np.searchsorted(uniq_parent, parent),
                         (1 << octant).astype(np.uint8))
        octree_levels.append(bytes_l)
        m = uniq_parent
    octree_levels.reverse()
    return torch.from_numpy(np.concatenate(octree_levels)).to(
        device_of(points, device))


def morton_to_octree(morton, level, device=None):
    """Sorted unique Morton codes at ``level`` → octree bytes."""
    return unbatched_points_to_octree(
        morton_to_points(morton, device="cpu"), level, sorted=True,
        device=device_of(morton, device))


def points_to_corners(points):
    """Each point's 8 cell corners, z fastest → (..., 8, 3)."""
    c = torch.arange(8, device=points.device)
    offs = torch.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], dim=-1).to(
        points.dtype)
    return points[..., None, :] + offs
