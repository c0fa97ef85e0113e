"""Voxelgrid → mesh conversions: cubic meshes and marching cubes.

Counterpart of ``kaolin_tpu/ops/conversions/voxelgrid.py`` (reference
``kaolin/ops/conversions/voxelgrid.py``: voxelgrids_to_cubic_meshes :56,
voxelgrids_to_trianglemeshes :169). The JAX package runs both as host
numpy; here they are torch operations on the grid's device, with the JAX
package's vertex and face order: marching-cubes vertices in ascending edge
key, each from the edge's first use, faces table slot by table slot; cube
vertices numbered in order of first use, direction by direction.
"""

import torch
from torch.nn import functional as F

from kaolin_tpu_torch.ops.conversions._mc_tables import (
    MC_EDGE_TABLE,
    MC_TRI_TABLE,
)

__all__ = ["voxelgrids_to_cubic_meshes", "voxelgrids_to_trianglemeshes"]

# cube corners in the classic Lorensen order (x, y, z)
_MC_CORNERS = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
               [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
# the 12 cube edges as (corner_a, corner_b)
_MC_EDGES = [[0, 1], [1, 2], [2, 3], [3, 0],
             [4, 5], [5, 6], [6, 7], [7, 4],
             [0, 4], [1, 5], [2, 6], [3, 7]]


def _first_occurrence(keys):
    """Unique keys (ascending) and, for each, the position of its first
    occurrence in ``keys``; and each key's unique id."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.long,
                       device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(keys.shape[0],
                                               device=keys.device), "amin")
    return uniq, first, inv


def _marching_cubes_single(vals, iso_value):
    """vals: padded (X, Y, Z) float32 lattice samples → (verts (V, 3)
    float32, faces (F, 3) int64) on its device."""
    device = vals.device
    nx, ny, nz = vals.shape
    corners = torch.tensor(_MC_CORNERS, device=device)
    edges = torch.tensor(_MC_EDGES, device=device)
    axes = [torch.arange(k - 1, device=device) for k in (nx, ny, nz)]
    cells = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                        -1).reshape(-1, 3)
    cc = cells[:, None, :] + corners[None]                     # (C, 8, 3)
    corner_vals = vals[cc[..., 0], cc[..., 1], cc[..., 2]]     # (C, 8)
    inside = corner_vals > iso_value
    cube_index = (inside.long() << torch.arange(8, device=device)).sum(-1)
    active = (cube_index != 0) & (cube_index != 255)
    if not bool(active.any()):
        return (torch.zeros((0, 3), device=device),
                torch.zeros((0, 3), dtype=torch.long, device=device))
    cells = cells[active]
    corner_vals = corner_vals[active]
    cube_index = cube_index[active]

    # global edge key: (lattice coords of the lower corner, axis)
    cg = cells[:, None, :] + corners[None]                     # (A, 8, 3)
    pa = cg[:, edges[:, 0]]                                    # (A, 12, 3)
    pb = cg[:, edges[:, 1]]
    lower = torch.minimum(pa, pb)
    axis = (pa - pb).abs().argmax(-1)
    edge_key = (((lower[..., 0] * ny + lower[..., 1]) * nz + lower[..., 2]) * 3
                + axis)                                        # (A, 12)

    edge_bits = torch.from_numpy(MC_EDGE_TABLE).to(device)[cube_index]
    edge_used = ((edge_bits[:, None] >> torch.arange(12, device=device)) & 1) \
        == 1                                                   # (A, 12)
    used_keys = edge_key[edge_used]
    va = corner_vals[:, edges[:, 0]][edge_used]
    vb = corner_vals[:, edges[:, 1]][edge_used]
    t = (iso_value - va) / torch.where((vb - va).abs() > 1e-12, vb - va,
                                       1e-12)
    t = t.clamp(0.0, 1.0).double()
    pa_u = pa[edge_used].double()
    pb_u = pb[edge_used].double()
    pos = pa_u + t[:, None] * (pb_u - pa_u)

    uniq_keys, first_idx, _ = _first_occurrence(used_keys)
    verts = pos[first_idx].float()
    edge_vert = torch.searchsorted(uniq_keys, edge_key)    # valid where used

    tri_rows = torch.from_numpy(MC_TRI_TABLE).to(device)[cube_index]
    faces = []
    for k in range(0, 15, 3):
        sel = tri_rows[:, k] >= 0
        if not bool(sel.any()):
            break
        idx = torch.nonzero(sel)[:, 0]
        faces.append(torch.stack([edge_vert[idx, tri_rows[idx, k + j]]
                                  for j in range(3)], dim=-1))
    return verts, torch.cat(faces, dim=0)


def voxelgrids_to_trianglemeshes(voxelgrids, iso_value=0.5):
    """Marching cubes over batched voxelgrids (B, X, Y, Z) → lists of
    (vertices, faces), on the grids' device. The values are samples at voxel
    centres with one voxel of zero padding, as in the reference (:228)."""
    vg = F.pad(torch.as_tensor(voxelgrids).float(), (1, 1, 1, 1, 1, 1))
    vertices_list, faces_list = [], []
    for i in range(vg.shape[0]):
        v, f = _marching_cubes_single(vg[i], iso_value)
        vertices_list.append(v)
        faces_list.append(f)
    return vertices_list, faces_list


_FACE_NEIGHBORS = [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1],
                   [0, 0, 1]]
# quad corner offsets for each face direction (outward-facing order)
_FACE_QUADS = [
    [[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]],
    [[1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]],
    [[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]],
    [[0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]],
    [[0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]],
    [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
]


def voxelgrids_to_cubic_meshes(voxelgrids, is_trimesh=True):
    """Binary voxelgrids (B, X, Y, Z) → lists of (vertices, faces): the
    exposed faces of the voxel cubes as quads or triangle pairs, vertices
    in voxel-corner coordinates numbered in order of first use."""
    vg = torch.as_tensor(voxelgrids).bool()
    device = vg.device
    quads_off = torch.tensor(_FACE_QUADS, device=device)       # (6, 4, 3)
    vertices_list, faces_list = [], []
    for b in range(vg.shape[0]):
        grid = F.pad(vg[b].to(torch.uint8), (1, 1, 1, 1, 1, 1)).bool()
        occ = torch.nonzero(vg[b])                             # (N, 3)
        corners = []
        for d, n in enumerate(_FACE_NEIGHBORS):
            nb = occ + torch.tensor(n, device=device) + 1
            exposed = ~grid[nb[:, 0], nb[:, 1], nb[:, 2]]
            corners.append(occ[exposed][:, None, :] + quads_off[d][None])
        corners = torch.cat(corners)                           # (Q, 4, 3)
        if corners.shape[0] == 0:
            vertices_list.append(torch.zeros((0, 3), device=device))
            faces_list.append(torch.zeros((0, 3 if is_trimesh else 4),
                                          dtype=torch.long, device=device))
            continue
        dims = torch.tensor(vg.shape[1:], device=device) + 1
        flat = corners.reshape(-1, 3)
        keys = (flat[:, 0] * dims[1] + flat[:, 1]) * dims[2] + flat[:, 2]
        _, first, inv = _first_occurrence(keys)
        by_first = torch.argsort(first)
        new_id = torch.empty_like(by_first)
        new_id[by_first] = torch.arange(by_first.shape[0], device=device)
        quad = new_id[inv].reshape(-1, 4)
        verts = flat[first[by_first]].float()
        if is_trimesh:
            faces = torch.stack([quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]],
                                dim=1).reshape(-1, 3)
        else:
            faces = quad
        vertices_list.append(verts)
        faces_list.append(faces)
    return vertices_list, faces_list
