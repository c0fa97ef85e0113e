"""Voxelgrid ops: downsample, surface extraction, fill, ODMs.

Counterpart of ``kaolin_tpu/ops/voxelgrid.py`` (reference
``kaolin/ops/voxelgrid.py``: downsample :21, extract_surface :92, fill
:143, extract_odms :208, project_odms :307). Pooling sums windows with
``avg_pool3d(divisor_override=1)`` and divides by the window's size as the
JAX package does; ``fill`` floods the outside from the padded boundary by
6-neighbourhood dilations until nothing changes.
"""

import torch
from torch.nn import functional as F

__all__ = ["downsample", "extract_surface", "fill", "extract_odms",
           "project_odms"]


def _avg_pool3d(x, kernel, stride, padding):
    """x (B, X, Y, Z) → the window sums over zero padding / window size."""
    summed = F.avg_pool3d(x[:, None], kernel, stride, padding,
                          divisor_override=1)[:, 0]
    return summed / float(kernel[0] * kernel[1] * kernel[2])


def downsample(voxelgrids, scale):
    """Average-pool a voxelgrid (B, X, Y, Z) by integer scale(s)."""
    if isinstance(scale, int):
        scale = [scale] * 3
    if len(scale) != 3:
        raise ValueError(f"expected scale of length 3, got {len(scale)}")
    for i, s in enumerate(scale):
        if s < 1:
            raise ValueError(f"downsample ratio must be >= 1, got {s} at {i}")
        if s > voxelgrids.shape[i + 1]:
            raise ValueError(f"downsample ratio {s} > grid dim "
                             f"{voxelgrids.shape[i + 1]}")
    return _avg_pool3d(voxelgrids.float(), scale, scale, (0, 0, 0))


def extract_surface(voxelgrids, mode="wide"):
    """Keep only the voxels that touch an empty voxel."""
    v = voxelgrids.float()
    vb = voxelgrids.bool()
    if mode == "wide":
        pooled = _avg_pool3d(v, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        return (pooled < 1) & vb
    if mode == "thin":
        px = _avg_pool3d(v, (3, 1, 1), (1, 1, 1), (1, 0, 0))
        py = _avg_pool3d(v, (1, 3, 1), (1, 1, 1), (0, 1, 0))
        pz = _avg_pool3d(v, (1, 1, 3), (1, 1, 1), (0, 0, 1))
        return ((px < 1) | (py < 1) | (pz < 1)) & vb
    raise ValueError(f'mode "{mode}" is not supported')


def _dilate6(x):
    """6-neighbourhood binary dilation of (B, X, Y, Z) bool."""
    f = x.float()[:, None]
    out = f
    for k, p in (((3, 1, 1), (1, 0, 0)), ((1, 3, 1), (0, 1, 0)),
                 ((1, 1, 3), (0, 0, 1))):
        out = torch.maximum(out, F.max_pool3d(f, k, 1, p))
    return out[:, 0] > 0


def fill(voxelgrids):
    """Fill internal holes (``binary_fill_holes``): flood the outside from
    the padded boundary, then take the complement. Not differentiable; one
    host read a dilation."""
    occupied = voxelgrids.bool()
    free = ~F.pad(occupied.to(torch.uint8), (1, 1, 1, 1, 1, 1)).bool()
    prev = torch.zeros_like(free)
    prev[:, 0] = free[:, 0]
    cur = _dilate6(prev) & free
    while not torch.equal(prev, cur):
        prev, cur = cur, _dilate6(cur) & free
    return ~cur[:, 1:-1, 1:-1, 1:-1]


def extract_odms(voxelgrids):
    """Orthographic depth maps from the 6 axis views → (B, 6, D, D) int64,
    in the order z_neg, z_pos, y_neg, y_pos, x_neg, x_pos."""
    vb = voxelgrids.bool()
    dim = vb.shape[-1]
    mult = torch.arange(1, dim + 1, device=vb.device)
    full = torch.stack([mult, mult.flip(0)], dim=0)           # (2, D)
    z_vals = (vb[:, None] * full.reshape(1, 2, 1, 1, -1)).amax(dim=4)
    y_vals = (vb[:, None] * full.reshape(1, 2, 1, -1, 1)).amax(dim=3)
    x_vals = (vb[:, None] * full.reshape(1, 2, -1, 1, 1)).amax(dim=2)
    return dim - torch.cat([z_vals, y_vals, x_vals], dim=1)


def project_odms(odms, voxelgrids=None, votes=1):
    """Carve a voxelgrid with 6 orthographic depth maps."""
    if odms.shape[1] != 6:
        raise ValueError(f"expected 6 odms, got {odms.shape[1]}")
    batch_size = odms.shape[0]
    dim = odms.shape[-1]
    if voxelgrids is None:
        voxelgrids = torch.ones((batch_size, dim, dim, dim), dtype=torch.bool,
                                device=odms.device)
    elif tuple(voxelgrids.shape) != (batch_size, dim, dim, dim):
        raise ValueError("voxelgrids shape mismatch with odms")

    upd = odms.reshape(batch_size, 3, 2, dim, dim).clone()
    upd[:, :, 0] = dim - upd[:, :, 0]
    upd = upd.reshape(batch_size, 6, dim, dim)
    base = torch.arange(dim, device=odms.device)

    z_neg = (base.reshape(1, 1, 1, -1) >= upd[:, 0][..., None]).int()
    z_pos = (base.reshape(1, 1, 1, -1) < upd[:, 1][..., None]).int()
    y_neg = (base.reshape(1, 1, -1, 1) >= upd[:, 2][..., None, :]).int()
    y_pos = (base.reshape(1, 1, -1, 1) < upd[:, 3][..., None, :]).int()
    x_neg = (base.reshape(1, -1, 1, 1) >= upd[:, 4][:, None]).int()
    x_pos = (base.reshape(1, -1, 1, 1) < upd[:, 5][:, None]).int()
    sum_of_mask = z_neg + z_pos + y_neg + y_pos + x_neg + x_pos
    return (voxelgrids.int() * votes - sum_of_mask) > 0
