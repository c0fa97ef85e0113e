"""SDF → voxelgrid by multiresolution isosurface extraction (MISE).

Counterpart of ``kaolin_tpu/ops/conversions/sdf.py`` (reference
``kaolin/ops/conversions/sdf.py:48``, the MISE C++ class): the SDF is
evaluated at ``init_res``, then only inside cells whose corners disagree,
halving the step until it is 1; the inside of a cell whose 8 corners agree
takes their value without evaluation. The user's callables get (N, 3)
float32 tensors on ``device``: the CUDA device unless another is named.
"""

import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["sdf_to_voxelgrids"]

_CORNER_OFFS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def sdf_to_voxelgrids(sdf, bbox_center=0.0, bbox_dim=1.0, init_res=32,
                      upsampling_steps=0, device=None):
    """Evaluate each callable SDF on an adaptively refined grid → (B, R+1,
    R+1, R+1) float32 binary voxelgrids (1 inside, where the SDF is <= 0)
    with R = init_res·2^steps, on ``device`` (the CUDA device when None)."""
    if not isinstance(sdf, (list, tuple)):
        raise TypeError("sdf must be a list of callables")
    device = resolve_device(device, "sdf_to_voxelgrids")
    final_res = init_res * 2 ** upsampling_steps
    return torch.stack([
        _mise_single(f, bbox_center, bbox_dim, init_res, final_res, device)
        for f in sdf]).float()


def _eval(f, coords, bbox_center, bbox_dim, final_res):
    """Integer grid coords at the final resolution (N, 3) → inside (N,)."""
    pts = (coords.double() / final_res - 0.5) * bbox_dim + bbox_center
    return torch.as_tensor(f(pts.float())).to(coords.device) <= 0


def _uniform_fill(cell_val, step, final_res):
    """The value a uniform cell gives each lattice point it holds (-1 where
    none holds it): cells that touch share a corner, so all cells holding a
    point agree and the largest value is theirs."""
    p = torch.arange(final_res + 1, device=cell_val.device)
    n = cell_val.shape[0]
    lo = (p // step).clamp(max=n - 1)
    hi = torch.where(p % step == 0, p // step - 1, p // step).clamp(min=0)
    out = None
    for ix in (lo, hi):
        for iy in (lo, hi):
            for iz in (lo, hi):
                v = cell_val[ix[:, None, None], iy[None, :, None],
                             iz[None, None, :]]
                out = v if out is None else torch.maximum(out, v)
    return out


def _mise_single(f, bbox_center, bbox_dim, init_res, final_res, device):
    occ = torch.full((final_res + 1,) * 3, -1, dtype=torch.int8,
                     device=device)                          # -1 unknown

    step = final_res // init_res
    base = torch.arange(0, final_res + 1, step, device=device)
    coarse = torch.stack(torch.meshgrid(base, base, base, indexing="ij"),
                         -1).reshape(-1, 3)
    inside = _eval(f, coarse, bbox_center, bbox_dim, final_res)
    occ[coarse[:, 0], coarse[:, 1], coarse[:, 2]] = inside.to(torch.int8)

    offs8 = torch.tensor(_CORNER_OFFS, device=device)
    cur_step = step
    while cur_step > 1:
        idx = torch.arange(0, final_res, cur_step, device=device)
        n = idx.shape[0]
        cells = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"),
                            -1).reshape(-1, 3)
        corners = cells[:, None, :] + cur_step * offs8
        cv = occ[corners[..., 0], corners[..., 1], corners[..., 2]]
        known = (cv >= 0).all(-1)
        mixed = (cv.amax(-1) != cv.amin(-1)) | ~known
        # a uniform cell's inside takes its corners' value
        uniform = known & ~mixed
        cell_val = torch.where(uniform, cv[:, 0], -1).reshape(n, n, n)
        fill = _uniform_fill(cell_val, cur_step, final_res)
        occ = torch.where(occ < 0, fill, occ)
        # evaluate the half-step lattice inside the mixed cells
        half = cur_step // 2
        r = torch.arange(0, cur_step + 1, half, device=device)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                           -1).reshape(-1, 3)
        new_pts = (cells[mixed][:, None, :] + offs[None]).reshape(-1, 3)
        new_pts = torch.unique(new_pts, dim=0)
        unknown = occ[new_pts[:, 0], new_pts[:, 1], new_pts[:, 2]] < 0
        new_pts = new_pts[unknown]
        if new_pts.shape[0] > 0:
            inside = _eval(f, new_pts, bbox_center, bbox_dim, final_res)
            occ[new_pts[:, 0], new_pts[:, 1], new_pts[:, 2]] = \
                inside.to(torch.int8)
        cur_step = half
    return occ.clamp(0, 1)
