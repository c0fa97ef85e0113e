"""Tetrahedral-mesh ops. Counterpart of ``kaolin_tpu/ops/mesh/tetmesh.py``:
topology on the host in numpy, geometry differentiable."""

import numpy as np
import torch

from kaolin_tpu_torch.ops.batch import host

__all__ = ["inverse_vertices_offset", "subdivide_tetmesh"]

_BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3])


def inverse_vertices_offset(tet_vertices):
    """Inverse of each tet's offset matrix [B − A; C − A; D − A]:
    (B, T, 4, 3) → (B, T, 3, 3)."""
    a = tet_vertices[..., 0:1, :]
    offset = torch.cat([tet_vertices[..., 1:2, :] - a,
                        tet_vertices[..., 2:3, :] - a,
                        tet_vertices[..., 3:4, :] - a], dim=-2)
    return torch.linalg.inv(offset)


def subdivide_tetmesh(vertices, tetrahedrons, features=None):
    """Split every tet into 8 at its edge midpoints; features are averaged
    on the edges. Returns (new_vertices, new_tets (T·8, 4) int64
    [, new_features])."""
    tets = host(tetrahedrons)
    all_edges = np.sort(tets[:, _BASE_TET_EDGES].reshape(-1, 2), axis=-1)
    unique_edges, idx_map = np.unique(all_edges, axis=0, return_inverse=True)
    idx_map = idx_map.reshape(-1) + vertices.shape[1]

    pos_feature = (torch.cat([vertices, features], -1)
                   if features is not None else vertices)
    ends = torch.as_tensor(unique_edges.reshape(-1), dtype=torch.long,
                           device=vertices.device)
    mid = pos_feature[:, ends].reshape(
        pos_feature.shape[0], -1, 2, pos_feature.shape[-1]).mean(dim=2)
    new_pos_feature = torch.cat([pos_feature, mid], dim=1)
    new_pos, new_features = new_pos_feature[..., :3], new_pos_feature[..., 3:]

    ia, ib, ic, id_ = [tets[:, i] for i in range(4)]
    edges6 = idx_map.reshape(-1, 6)
    iab, iac, iad, ibc, ibd, icd = [edges6[:, i] for i in range(6)]
    new_tets = np.concatenate([
        np.stack([ia, iab, iac, iad], 1),
        np.stack([ib, ibc, iab, ibd], 1),
        np.stack([ic, iac, ibc, icd], 1),
        np.stack([id_, iad, icd, ibd], 1),
        np.stack([iab, iac, iad, ibd], 1),
        np.stack([iab, iac, ibd, ibc], 1),
        np.stack([icd, iac, ibd, iad], 1),
        np.stack([icd, iac, ibc, ibd], 1),
    ], axis=0)
    new_tets = torch.as_tensor(new_tets, dtype=torch.int64,
                               device=vertices.device)
    if features is None:
        return new_pos, new_tets
    return new_pos, new_tets, new_features
