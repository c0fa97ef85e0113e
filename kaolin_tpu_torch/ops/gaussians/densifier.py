"""Volumetric interior sampling of 3D gaussian splats ("densifier").

Counterpart of ``kaolin_tpu/ops/gaussians/densifier.py`` (reference
``kaolin/ops/gaussians/densifier.py:227``, ``sample_points_in_volume``;
algorithm at ``ops/gaussian/densifier.py:78-110``):

1. gaussians → shell voxelization (:func:`gs_to_voxelgrid`, opacity-culled)
   → octree (ref _solidify :133-190);
2. carve seen-empty space by raytracing depth maps from icosahedral
   viewpoints and fusing them into a 3-state octree
   (:func:`kaolin_tpu_torch.ops.spc.bf_recon.bf_recon`); interior =
   occupied ∪ unseen voxels (``method="carve"``, the reference pipeline). A
   cheaper ``method="floodfill"`` carves the exterior with a flood fill from
   the grid boundary instead (``scipy.ndimage`` on the host) — equivalent
   for watertight shells;
3. jittered voxel-center sampling, optional subsampling and post-scaling.

Everything but the flood fill runs on one device: the CUDA device unless
the caller names another or passes tensors (their device). The draws
(the jitter and the subsample) come from a ``torch.Generator``.
"""

import logging
import math

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions.gaussians import gs_to_voxelgrid
from kaolin_tpu_torch.utils.backend import input_device

logger = logging.getLogger(__name__)

__all__ = ["sample_points_in_volume"]


def _generate_default_viewpoints():
    """Empirical carving anchors + 5 rotated/scaled icosahedra. Ref :36."""
    anchors = np.array([
        [4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0],
        [-4.0, 0.0, 0.0], [0.0, -4.0, 0.0], [0.0, 0.0, -4.0],
        [2.3, 2.3, 2.3], [-2.3, 2.3, 2.3], [2.3, -2.3, 2.3],
        [2.3, 2.3, -2.3], [-2.3, -2.3, 2.3], [-2.3, 2.3, -2.3],
        [2.3, -2.3, -2.3], [-2.3, -2.3, -2.3]], dtype=np.float64)
    phi = (1 + math.sqrt(5.0)) / 2
    ico = np.array([
        [+phi, +1.0, 0.0], [+phi, -1.0, 0.0], [-phi, -1.0, 0.0],
        [-phi, +1.0, 0.0], [+1.0, 0.0, +phi], [-1.0, 0.0, +phi],
        [-1.0, 0.0, -phi], [+1.0, 0.0, -phi], [0.0, +phi, +1.0],
        [0.0, +phi, -1.0], [0.0, -phi, -1.0], [0.0, -phi, +1.0]],
        dtype=np.float64)

    tx, ty, tz = np.deg2rad([15.0, 27.0, 49.0])
    rx = np.array([[1, 0, 0], [0, np.cos(tx), -np.sin(tx)],
                   [0, np.sin(tx), np.cos(tx)]])
    ry = np.array([[np.cos(ty), 0, np.sin(ty)], [0, 1, 0],
                   [-np.sin(ty), 0, np.cos(ty)]])
    rz = np.array([[np.cos(tz), -np.sin(tz), 0],
                   [np.sin(tz), np.cos(tz), 0], [0, 0, 1]])
    r = rz @ ry @ rx
    rings = [anchors, ico]
    rk = r
    for k in range(2, 7):
        rings.append((k * ico) @ rk.T)
        rk = r @ rk
    views = np.concatenate(rings, axis=0)
    rng = np.random.RandomState(0)
    return (views + 0.001 * (0.5 - rng.rand(*views.shape))) \
        .astype(np.float32)


def _carve_interior(shell_voxels, level, viewpoints=None):
    """Reference carving (ref _solidify :190-218): raytrace the shell octree
    from the viewpoints, fuse with Bayesian fusion, keep the voxels not
    observed empty. ``shell_voxels`` (K, 3) int tensor; returns the kept
    voxel coords (int16) on its device, or None on failure."""
    from kaolin_tpu_torch.ops.spc import (
        RayTracedSPCDataset,
        morton_to_points,
        scan_octrees,
        unbatched_points_to_octree,
    )
    from kaolin_tpu_torch.ops.spc.bf_recon import bf_recon, unbatched_query

    if viewpoints is None:
        viewpoints = _generate_default_viewpoints()
    device = shell_voxels.device
    gs_octree = unbatched_points_to_octree(shell_voxels.to(torch.int16),
                                           level)
    dataset = RayTracedSPCDataset(viewpoints, gs_octree)
    bf_octree, bf_empty, _, _ = bf_recon(dataset, final_level=level,
                                         sigma=0.0005)
    if bf_octree is None or len(bf_octree) == 0:
        return None
    _, _, exsum = scan_octrees(
        bf_octree, torch.tensor([len(bf_octree)], dtype=torch.int32))
    query_points = morton_to_points(torch.arange(8 ** level, device=device))
    result = unbatched_query(bf_octree, bf_empty, exsum, query_points, level)
    return query_points[result != -1]  # occupied + unseen (interior)


def _floodfill_interior(shell, all_points, res):
    """Boundary flood-fill carving (cheap alternative, host numpy and
    scipy): close small shell holes, fill, erode away the closing
    inflation. Returns (K, 3) int64 numpy coords."""
    from scipy import ndimage
    grid = np.zeros((res, res, res), dtype=bool)
    grid[shell[:, 0], shell[:, 1], shell[:, 2]] = True
    grid_all = np.zeros((res, res, res), dtype=bool)
    grid_all[all_points[:, 0], all_points[:, 1], all_points[:, 2]] = True
    closed = ndimage.binary_closing(grid_all, structure=np.ones((3, 3, 3)),
                                    iterations=2)
    filled = ndimage.binary_fill_holes(closed)
    interior = ndimage.binary_erosion(filled, structure=np.ones((3, 3, 3)),
                                      iterations=2)
    return np.stack(np.nonzero(interior | grid), axis=-1)


def _uniform(gen, n, device, low=0.0, high=1.0):
    """n uniform float32 draws in [low, high) from ``gen``, made on its
    device and moved to ``device``."""
    u = torch.rand((n,), generator=gen, device=gen.device)
    return (u * (high - low) + low).to(device)


def sample_points_in_volume(xyz, scale, rotation, opacity, mask=None,
                            num_samples=None, octree_level=8,
                            opacity_threshold=0.35, post_scale_factor=1.0,
                            jitter=True, clip_samples_to_input_bbox=True,
                            viewpoints=None, method="carve", key=None,
                            device=None, **unused):
    """Sample points uniformly inside the solid represented by 3D gaussians.

    Args/semantics follow the reference (:227); ``method`` selects the
    volume-filling backend: "carve" (multi-view Bayesian-fusion carving, the
    reference pipeline) or "floodfill" (boundary flood fill — faster,
    equivalent for watertight shells). ``key``: a ``torch.Generator`` (on
    any device; its draws are moved) or an int seed (None: 0) of a
    generator on the run's device. ``device``: None means the device of
    ``xyz`` when it is a tensor, else the CUDA device. Returns (S, 3)
    float32 sampled points on that device.
    """
    assert 6 <= octree_level <= 10, "octree_level range supported is [6, 10]"
    device = input_device(xyz, device, "sample_points_in_volume")
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=device).manual_seed(0 if key is None
                                                   else int(key))

    def f64(a):
        return torch.as_tensor(a).to(device, torch.float64)

    xyz_d, scale_d, rot_d = f64(xyz), f64(scale), f64(rotation)
    op_d = f64(opacity).reshape(-1)
    if mask is not None:
        m = torch.as_tensor(mask).to(device).reshape(-1)
        xyz_d, scale_d, rot_d, op_d = xyz_d[m], scale_d[m], rot_d[m], op_d[m]

    # normalize to [-1, 1] cube (ref :159-175: dmax = half max-extent + 0.05)
    lo = xyz_d.amin(dim=0)
    hi = xyz_d.amax(dim=0)
    center = 0.5 * (lo + hi)
    dmax = float(0.5 * (hi - lo).max() + 0.05)
    xyz_n = (xyz_d - center) / dmax
    scale_n = scale_d / dmax

    res = 2 ** octree_level
    points, opac = gs_to_voxelgrid(xyz_n, scale_n, rot_d, op_d, octree_level)
    shell = points[opac >= opacity_threshold]
    if shell.shape[0] == 0:
        shell = points

    occ = None
    if method == "carve":
        occ = _carve_interior(shell, octree_level, viewpoints)
        if occ is None:
            logger.warning(
                "3D Gaussian densifier failed to produce a voxelized volume;"
                " the shell may have holes. Try reducing opacity_threshold"
                " or octree_level. Falling back to flood-fill carving.")
    if occ is None:
        occ = torch.from_numpy(_floodfill_interior(
            shell.cpu().numpy().astype(np.int64),
            points.cpu().numpy().astype(np.int64), res)).to(device)

    pts = ((occ.double() + 0.5) * (2.0 / res) - 1.0).float()
    if jitter:
        # spherical jitter bounded by the cell radius (ref _jitter :111)
        n = pts.shape[0]
        cell_radius = 2.0 / res
        radius = cell_radius * torch.sqrt(_uniform(gen, n, device))
        azimuth = _uniform(gen, n, device, high=2 * math.pi)
        elevation = _uniform(gen, n, device, -math.pi / 2, math.pi / 2)
        delta = torch.stack([
            radius * torch.sin(elevation) * torch.cos(azimuth),
            radius * torch.sin(elevation) * torch.sin(azimuth),
            radius * torch.cos(elevation)], dim=1)
        pts = pts + delta

    # denormalize + optional post scaling about the centroid (ref :404-410)
    pts = pts * dmax + center.float()
    if post_scale_factor < 1.0:
        c = pts.mean(dim=0)
        pts = (pts - c) * post_scale_factor + c
    if clip_samples_to_input_bbox:
        # failsafe: drop (not clamp) samples outside the input bbox (:412)
        inside = torch.all((pts > lo.float()) & (pts < hi.float()), dim=1)
        pts = pts[inside]
    if num_samples is not None and num_samples < pts.shape[0]:
        idx = torch.randperm(pts.shape[0], generator=gen,
                             device=gen.device)[:num_samples]
        pts = pts[idx.to(device)]
    return pts
