"""3D gaussians → voxelgrid overlap + opacity integration.

Counterpart of ``kaolin_tpu/ops/conversions/gaussians.py`` (reference
``kaolin/ops/conversions/gaussians.py:24``): per-gaussian iso-ellipsoid
boxes enumerate candidate voxels, the gaussian's density is averaged over
``step`` samples along each voxel's z axis, and the opacities that fall in
one voxel combine as ``1 − ∏(1 − α)``. Float64 throughout, as there.

The JAX package enumerates the (gaussian, voxel) pairs with a host loop
and holds all of them at once; at level 8 a 2,000-gaussian shell has about
1.8 G candidates. Here they are enumerated on the device by index
arithmetic, in chunks of gaussians of at most ``MAX_CANDIDATES``
candidates, and ``log1p(−α)`` is accumulated with ``index_add_`` into a
dense float64 grid indexed by Morton code (res³ entries, 134 MB at level
8), so the touched cells come out in Morton order. Only the order of the
sums differs from the JAX package's ``np.add.at``.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import morton_to_points, points_to_morton
from kaolin_tpu_torch.utils.backend import input_device

__all__ = ["gs_to_voxelgrid"]

MAX_CANDIDATES = 1 << 24


def _quat_to_mat(q):
    """wxyz quaternions (N, 4) → rotation matrices (N, 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _entries(cov_inv, g):
    """The nine entries of cov_inv[g], each (M,), gathered one at a time
    (no (M, 3, 3) gather)."""
    return [[cov_inv[:, i, j][g] for j in range(3)] for i in range(3)]


def _quad_form(d, c):
    """dᵀ C d for offsets d = (d0, d1, d2) and entries ``c`` of C."""
    out = None
    for i in range(3):
        row = c[i][0] * d[0] + c[i][1] * d[1] + c[i][2] * d[2]
        out = d[i] * row if out is None else out + d[i] * row
    return out


def _chunks(counts, limit):
    """Split gaussians (host int64 counts) into consecutive runs of at most
    ``limit`` candidates (a gaussian above the limit alone) → [(a, b)]."""
    bounds, start, acc = [], 0, 0
    for i, c in enumerate(counts.tolist()):
        if acc and acc + c > limit:
            bounds.append((start, i))
            start, acc = i, 0
        acc += c
    if start < len(counts):
        bounds.append((start, len(counts)))
    return bounds


def gs_to_voxelgrid(xyz, scales, rots, opacities, level, iso=11.345,
                    tol=1.0 / 8.0, step=10, device=None):
    """Voxelize gaussians at resolution 2^level (coordinates assumed in
    [-1, 1]). Returns (voxel coords (V, 3) int16 Morton-sorted, accumulated
    opacities (V,) float32) on ``device``: None means the device of ``xyz``
    when it is a tensor, else the CUDA device. Ref :24."""
    device = input_device(xyz, device, "gs_to_voxelgrid")

    def f64(a):
        return torch.as_tensor(a).to(device, torch.float64)

    xyz, scales, rots = f64(xyz), f64(scales), f64(rots)
    opacities = f64(opacities).reshape(-1)
    res = 2 ** level
    voxel_size = 2.0 / res

    # covariance with numerically-invertible clamped scales (ref tol)
    s = torch.clamp(scales, min=tol * voxel_size)
    r = _quat_to_mat(rots)
    cov = r @ (s[:, :, None] ** 2 * r.transpose(-1, -2))
    cov_inv = torch.linalg.inv(cov)

    # iso-ellipsoid AABB half extents: sqrt(iso * diag(cov))
    half = torch.sqrt(iso * torch.diagonal(cov, dim1=-2, dim2=-1))
    lo = torch.clamp(torch.floor((xyz - half + 1.0) / voxel_size).long(),
                     0, res - 1)
    hi = torch.clamp(torch.floor((xyz + half + 1.0) / voxel_size).long(),
                     0, res - 1)
    ext = hi - lo + 1
    counts = ext.prod(dim=1)

    log_t = torch.zeros(res ** 3, dtype=torch.float64, device=device)
    touched = torch.zeros(res ** 3, dtype=torch.bool, device=device)
    # samples along the voxel's z axis through its center
    offsets = ((np.arange(step) + 0.5) / step - 0.5) * voxel_size
    for a, b in _chunks(counts.cpu().numpy(), MAX_CANDIDATES):
        c = counts[a:b]
        g = torch.repeat_interleave(torch.arange(a, b, device=device), c)
        first = torch.cumsum(c, 0) - c
        k = torch.arange(g.shape[0], device=device) - first[g - a]
        nyz = ext[g, 1] * ext[g, 2]
        ix = k // nyz
        rem = k - ix * nyz
        iy = rem // ext[g, 2]
        iz = rem - iy * ext[g, 2]
        vox = lo[g] + torch.stack([ix, iy, iz], dim=1)
        del k, nyz, ix, rem, iy, iz

        d = (vox.double() + 0.5) * voxel_size - 1.0 - xyz[g]
        keep = _quad_form(d.unbind(1), _entries(cov_inv, g)) <= iso
        vox, g, d = vox[keep], g[keep], d[keep]

        # opacity integration: average gaussian density over the samples
        entries = _entries(cov_inv, g)
        d0, d1, d2 = d.unbind(1)
        dens = torch.zeros_like(d0)
        for off in offsets.tolist():
            dens += torch.exp(-0.5 * _quad_form((d0, d1, d2 + off), entries))
        alpha = torch.clamp(opacities[g] * (dens / step), 0.0, 0.9999)

        morton = points_to_morton(vox)
        log_t.index_add_(0, morton, torch.log1p(-alpha))
        touched[morton] = True

    uniq = torch.nonzero(touched).squeeze(1)
    sum_opacity = 1.0 - torch.exp(log_t[uniq])
    return morton_to_points(uniq), sum_opacity.float()
