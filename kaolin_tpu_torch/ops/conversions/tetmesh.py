"""Marching tetrahedra (DMTet): an SDF on a tet grid → triangle meshes.

Counterpart of ``kaolin_tpu/ops/conversions/tetmesh.py`` (reference
``kaolin/ops/conversions/tetmesh.py:116``), with its per-tet tables.

* :func:`marching_tetrahedra`: the reference's API, exact shapes; the
  topology is found on the SDF's device with its sizes read back,
  the vertices are differentiable.
* :func:`marching_tetrahedra_fixed`: fixed shapes for training loops: a
  vertex slot for every unique grid edge with a validity mask, 2 face slots
  a tet with a mask; no host read.
"""

import torch

from kaolin_tpu_torch.utils.numerics import rank_map, unique_pairs

__all__ = ["marching_tetrahedra", "marching_tetrahedra_fixed"]

# per-tet triangulation: entries index the 6 tet edges in _BASE_TET_EDGES
# order
_TRIANGLE_TABLE = [
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
]
_NUM_TRIANGLES = [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0]
_BASE_TET_EDGES = [0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3]


def _sorted_edges(tets):
    """Each tet's 6 edges as (6T, 2) sorted vertex pairs."""
    edges = tets[:, _BASE_TET_EDGES].reshape(-1, 2)
    return torch.sort(edges, dim=-1).values


def _grid_topology(tets, n):
    """The fixed edge topology of a tet grid: its unique sorted edges and
    each tet's 6 edge ids."""
    unique_edges, idx_map, _ = unique_pairs(_sorted_edges(tets), n)
    return unique_edges, idx_map.reshape(-1, 6)


def _interp_verts(vertices, sdf, edges):
    """The SDF's zero crossing on (E, 2) vertex-id edges → (E, 3)."""
    va = vertices[edges[:, 0]]
    vb = vertices[edges[:, 1]]
    sa = sdf[edges[:, 0]][:, None]
    sb = -sdf[edges[:, 1]][:, None]
    denom = sa + sb
    denom = torch.where(denom.abs() > 1e-12, denom,
                        torch.where(denom >= 0, 1e-12, -1e-12))
    return (va * sb + vb * sa) / denom


def _unbatched_marching_tetrahedra(vertices, tets, sdf, return_tet_idx):
    device = vertices.device
    occ_n = sdf.detach() > 0
    occ_fx4 = occ_n[tets]
    occ_sum = occ_fx4.sum(-1)
    valid_tets = (occ_sum > 0) & (occ_sum < 4)

    unique_edges, idx_map, _ = unique_pairs(
        _sorted_edges(tets[valid_tets]), vertices.shape[0])
    mask_edges = occ_n[unique_edges].sum(-1) == 1
    idx_map = rank_map(mask_edges)[idx_map].reshape(-1, 6)
    verts = _interp_verts(vertices, sdf, unique_edges[mask_edges])

    pow2 = 2 ** torch.arange(4, device=device)
    tetindex = (occ_fx4[valid_tets] * pow2).sum(-1)
    num_triangles = torch.tensor(_NUM_TRIANGLES, device=device)[tetindex]
    tri_rows = torch.tensor(_TRIANGLE_TABLE, device=device)[tetindex]
    one, two = num_triangles == 1, num_triangles == 2
    f1 = torch.gather(idx_map[one], 1, tri_rows[one][:, :3])
    f2 = torch.gather(idx_map[two], 1, tri_rows[two][:, :6]).reshape(-1, 3)
    faces = torch.cat([f1.reshape(-1, 3), f2], dim=0)
    if return_tet_idx:
        tet_idx = torch.nonzero(valid_tets)[:, 0]
        tet_idx = torch.cat([tet_idx[one],
                             tet_idx[two].repeat_interleave(2)])
        return verts, faces, tet_idx
    return verts, faces


def marching_tetrahedra(vertices, tets, sdf, return_tet_idx=False):
    """Batched marching tetrahedra with the reference's API: per item lists
    of (vertices, faces[, tet_idx]), exact shapes, on the inputs' device.
    See :func:`marching_tetrahedra_fixed` for fixed shapes."""
    tets = torch.as_tensor(tets, device=vertices.device).long()
    outs = [_unbatched_marching_tetrahedra(vertices[b], tets, sdf[b],
                                           return_tet_idx)
            for b in range(vertices.shape[0])]
    return tuple(list(x) for x in zip(*outs))


def marching_tetrahedra_fixed(vertices, tets, sdf):
    """Marching tetrahedra of one grid with fixed shapes and no host read.

    Args:
        vertices: (V, 3).
        tets: (T, 4) grid (tensor or array).
        sdf: (V,).

    Returns a dict: verts (E, 3), the zero crossing on every unique grid
    edge (meaningless where inactive), vert_mask (E,), faces (2T, 3) into
    verts, face_mask (2T,), tet_idx (2T,).
    """
    device = vertices.device
    tets = torch.as_tensor(tets, device=device).long()
    unique_edges, tet_edge_ids = _grid_topology(tets, vertices.shape[0])

    occ = sdf > 0
    verts = _interp_verts(vertices, sdf, unique_edges)
    vert_mask = occ[unique_edges].sum(-1) == 1

    tetindex = (occ[tets].long()
                * 2 ** torch.arange(4, device=device)).sum(-1)
    tri_rows = torch.tensor(_TRIANGLE_TABLE, device=device)[tetindex]
    num_tri = torch.tensor(_NUM_TRIANGLES, device=device)[tetindex]
    # faces in edge-id space: (T, 2, 3)
    faces = torch.gather(tet_edge_ids, 1, tri_rows.clamp(0, 5)).reshape(-1, 3)
    face_mask = (num_tri[:, None] >= torch.tensor(
        [1, 2], device=device)[None]).reshape(-1)
    tet_idx = torch.arange(tets.shape[0], device=device).repeat_interleave(2)
    return {
        "verts": verts,
        "vert_mask": vert_mask,
        "faces": faces,
        "face_mask": face_mask,
        "tet_idx": tet_idx,
    }
