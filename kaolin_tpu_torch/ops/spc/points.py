"""SPC point utilities: quantization, Morton codes, octree construction,
cell corners and trilinear interpolation.

Counterpart of ``kaolin_tpu/ops/spc/points.py``. Morton convention: (x, y,
z) interleaved with z in the least significant bit of each triplet, so
[0, 0, 1] → 1, [0, 1, 0] → 2, [1, 0, 0] → 4.

Morton codes are torch bit operations on the device of their input (the
CPU for an array). The octree's bytes are packed on the host in numpy, as
in the JAX package: the octree has a variable length and is built once per
asset. Each returns a tensor on ``device``; where it is None, on the device
of the input when that is a tensor, else on the card (raising without one:
host inputs go to the CPU only when it is named). Interpolation runs on
the device of its inputs and is differentiable by autograd through its
gathers.
"""

import warnings

import numpy as np
import torch

from kaolin_tpu_torch.utils.backend import first_tensor, resolve_device

__all__ = [
    "quantize_points",
    "points_to_morton",
    "morton_to_points",
    "unbatched_points_to_octree",
    "morton_to_octree",
    "points_to_corners",
    "coords_to_trilinear_coeffs",
    "unbatched_interpolate_trilinear",
    "create_dense_spc",
    "coords_to_trilinear",
]


def host(x):
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_of(x, device, *more):
    """``device`` if given, else the device of the first tensor of ``x``
    and ``more``, else the card: an SPC op given host arrays runs on the
    card unless the CPU is named, and raises where there is no card."""
    if device is None:
        t = first_tensor(x, *more)
        if t is not None:
            return t.device
    return resolve_device(device, "the SPC op")


def _spread_bits(x):
    """Spread 16-bit ints so bits occupy every third position (int64)."""
    x = x.to(torch.int64) & 0xFFFF
    x = (x | (x << 16)) & 0x0000FF0000FF
    x = (x | (x << 8)) & 0x00F00F00F00F
    x = (x | (x << 4)) & 0x0C30C30C30C3
    x = (x | (x << 2)) & 0x249249249249
    return x


def _compact_bits(x):
    x = x & 0x249249249249
    x = (x | (x >> 2)) & 0x0C30C30C30C3
    x = (x | (x >> 4)) & 0x00F00F00F00F
    x = (x | (x >> 8)) & 0x0000FF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def _int64_tensor(x):
    """A tensor as it is, or an array-like as an int64 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.int64))


def quantize_points(x, level):
    """[-1, 1] floats → int16 grid coords in [0, 2^level − 1]."""
    res = 2 ** level
    return torch.floor(torch.clamp(res * (x + 1.0) / 2.0, 0, res - 1.0)).to(
        torch.int16)


def points_to_morton(points, device=None):
    """(..., 3) int coords → (...,) int64 Morton codes, by torch bit
    operations on ``device`` (:func:`device_of`)."""
    pts = _int64_tensor(points).to(device_of(points, device))
    m = (_spread_bits(pts[..., 0]) << 2 | _spread_bits(pts[..., 1]) << 1
         | _spread_bits(pts[..., 2]))
    return m


def morton_to_points(morton, device=None):
    """(...,) Morton codes → (..., 3) int16 coords, by torch bit operations
    on ``device`` (:func:`device_of`)."""
    m = _int64_tensor(morton).to(device_of(morton, device), torch.int64)
    return torch.stack([_compact_bits(m >> 2), _compact_bits(m >> 1),
                        _compact_bits(m)], dim=-1).to(torch.int16)


def unbatched_points_to_octree(points, level, sorted=False, device=None):
    """Quantized points (N, 3) at ``level`` → byte-packed octree, uint8.

    ``sorted=True`` says the points are already unique."""
    m = points_to_morton(points, "cpu").reshape(-1)
    return morton_to_octree(m if sorted else torch.unique(m), level,
                            device_of(points, device))


def morton_to_octree(morton, level, device=None):
    """Unique Morton codes at ``level`` → octree bytes, packed level by
    level from the root on the host."""
    m = np.sort(host(morton).astype(np.int64))
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
        device_of(morton, device))


def points_to_corners(points):
    """Each point's 8 cell corners, z fastest → (..., 8, 3)."""
    c = torch.arange(8, device=points.device)
    offs = torch.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], dim=-1).to(
        points.dtype)
    return points[..., None, :] + offs


def coords_to_trilinear_coeffs(coords, points, level):
    """Trilinear coefficients of [-1, 1] ``coords`` inside the cells whose
    quantized origins are ``points`` → (..., 8), corners z fastest."""
    points = points.to(coords.dtype)
    x = (coords + 1.0) * (2 ** level / 2.0) - points   # local, in [0, 1]
    xp = 1.0 - x
    cx = torch.stack([xp[..., 0]] * 4 + [x[..., 0]] * 4, dim=-1)
    cy = torch.stack([xp[..., 1], xp[..., 1], x[..., 1], x[..., 1]] * 2,
                     dim=-1)
    cz = torch.stack([xp[..., 2], x[..., 2]] * 4, dim=-1)
    return cx * cy * cz


def unbatched_interpolate_trilinear(coords, pidx, point_hierarchy, trinkets,
                                    feats, level):
    """Trilinearly interpolate per-corner features at query coords.

    Args:
        coords: (N, S, 3) in [-1, 1] (S samples per query point).
        pidx: (N,) indices into ``point_hierarchy`` (as from
            ``unbatched_query``); -1 for misses, which give zeros.
        point_hierarchy: (num_points, 3) int16.
        trinkets: (num_points, 8) corner indices into ``feats``.
        feats: (num_corners, D).
        level: the octree level of the query.

    Returns:
        (N, S, D), differentiable in ``coords`` and ``feats``.
    """
    valid = pidx >= 0
    safe = torch.where(valid, pidx, 0).long()
    cell = point_hierarchy[safe].to(coords.dtype)             # (N, 3)
    coeffs = coords_to_trilinear_coeffs(coords, cell[:, None, :], level)
    corner_feats = feats[trinkets[safe].long()]               # (N, 8, D)
    out = torch.einsum("nsc,ncd->nsd", coeffs,
                       corner_feats.to(coords.dtype))
    return torch.where(valid[:, None, None], out, 0.0)


def create_dense_spc(level, device=None):
    """A fully dense octree of ``level`` → (octree uint8, lengths int32),
    on ``device`` (the CPU when None)."""
    num_bytes = sum(8 ** lv for lv in range(level))
    octree = torch.full((num_bytes,), 255, dtype=torch.uint8, device=device)
    return octree, torch.tensor([num_bytes], dtype=torch.int32,
                                device=device)


def coords_to_trilinear(coords, points, level):
    """Deprecated alias of :func:`coords_to_trilinear_coeffs`."""
    warnings.warn("coords_to_trilinear is deprecated, "
                  "use coords_to_trilinear_coeffs", DeprecationWarning)
    return coords_to_trilinear_coeffs(coords, points, level)
