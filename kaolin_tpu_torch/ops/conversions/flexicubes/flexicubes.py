"""FlexiCubes: differentiable isosurface extraction with learnable weights.

Counterpart of ``kaolin_tpu/ops/conversions/flexicubes/flexicubes.py``
("Flexible Isosurface Extraction for Gradient-Based Mesh Optimization",
Shen et al., SIGGRAPH 2023): dual marching cubes with per-cube learnable
edge weights (beta), corner weights (alpha) and quad-split weights (gamma),
the L_dev regularizer (Eq. 8) and the QEF path when a surface-gradient
function is given.

Two phases, as in the JAX package: the topology (the sign-dependent index
structure: surface cubes and edges, DMC case ids, dual-vertex groups, quads)
comes from :meth:`FlexiCubes.precompute_topology`, here as torch operations
on the field's device that read back to the host only the sizes they need;
the geometry (zero crossings, weighted dual vertices, L_dev, the quad split)
is differentiable in the scalar field, the vertices and beta/alpha/gamma for
a fixed topology. :meth:`FlexiCubes.jit_extract` does both with fixed shapes
and no host read.
"""

from typing import NamedTuple

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions.flexicubes._tables import (
    CHECK_TABLE,
    DMC_TABLE,
    NUM_VD_TABLE,
    TET_TABLE,
)
from kaolin_tpu_torch.utils.backend import resolve_device
from kaolin_tpu_torch.utils.numerics import (
    nonzero_static,
    rank_map,
    unique_pairs,
)

__all__ = ["FlexiCubes"]

_CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                          [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                         dtype=np.float64)
_CUBE_EDGES = [0, 1, 1, 5, 4, 5, 0, 4, 2, 3, 3, 7, 6, 7, 2, 6,
               2, 0, 3, 1, 7, 5, 6, 4]
_QUAD_SPLIT_1 = [0, 1, 2, 0, 2, 3]
_QUAD_SPLIT_2 = [0, 1, 3, 3, 1, 2]
_QUAD_SPLIT_TRAIN = [0, 1, 1, 2, 2, 3, 3, 0]

# tetrahedralization: the axis of each cube edge, the face shared by
# consecutive cubes around an edge of a given axis, and the ring order of
# the 4 cubes around an edge
_EDGE_DIR_TABLE = np.array([0, 2, 0, 2, 0, 2, 0, 2, 1, 1, 1, 1],
                           dtype=np.int64)
_DIR_FACES_TABLE = np.array([
    [[5, 4], [3, 2], [4, 5], [2, 3]],
    [[5, 4], [1, 0], [4, 5], [0, 1]],
    [[3, 2], [1, 0], [2, 3], [0, 1]],
], dtype=np.int64)
_ADJ_PAIRS = [0, 1, 1, 3, 3, 2, 2, 0]


class _Topology(NamedTuple):
    """Index structure extracted from the sign pattern (tensors on the
    field's device)."""
    surf_cubes: torch.Tensor        # (C,) bool
    case_ids: torch.Tensor          # (Cs,)
    surf_edges: torch.Tensor        # (E, 2) vertex ids
    idx_map: torch.Tensor           # (Cs, 12) cube edge → surface edge or -1
    edge_group: torch.Tensor        # (G,) cube-edge slot of each group entry
    edge_group_to_vd: torch.Tensor  # (G,)
    edge_group_to_cube: torch.Tensor  # (G,) surface-cube row
    vd_num_edges: torch.Tensor      # (V, 1)
    vd_gamma_cube: torch.Tensor     # (V,) surface-cube row giving gamma
    total_num_vd: int
    quad_vd_idx: torch.Tensor       # (Q, 4) dual-vertex ids of each quad
    quad_cube: None                 # unused (kept for the JAX layout)
    quad_s_edge: torch.Tensor       # (Q,) surface edge the quad wraps
    flip_mask: torch.Tensor         # (Q,) bool


class _TetTopology(NamedTuple):
    """Index structure of the interior tetrahedralization, in the final
    vertex space [dual vertices (+ quad centres when training), inside grid
    vertices, inside cube centres]."""
    inside_grid_idx: torch.Tensor   # (Ni,) grid ids of inside vertices
    inside_cube_rows: torch.Tensor  # (Nc, 8) corner grid ids of inside cubes
    apex_idx: torch.Tensor          # (Qf,) apex vertex of each surface face
    tets_inside: torch.Tensor       # (Ti, 4) interior tets


def _table(array, device):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum`` along dim 0 (differentiable)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


class FlexiCubes:
    """Mesh extraction from scalar fields with learnable weights.

    ``device`` is where :meth:`construct_voxel_grid` puts the grid: the
    CUDA device when it is None (raising without one), or the device named,
    as ``device="cpu"``. Every other method runs on its inputs' device.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device, "FlexiCubes")

    def construct_voxel_grid(self, resolution):
        """Regular grid: vertices in [-0.5, 0.5] and the cubes' corner
        indices → ((R+1)³, 3) float32 vertices, (R³, 8) int64 cube_idx on
        ``self.device``. The vertices are made in float64 and rounded once,
        after the shift."""
        if isinstance(resolution, int):
            resolution = (resolution, resolution, resolution)
        rx, ry, rz = resolution
        gx, gy, gz = np.meshgrid(np.arange(rx + 1), np.arange(ry + 1),
                                 np.arange(rz + 1), indexing="ij")
        verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        verts = verts.astype(np.float64) / np.array([rx, ry, rz],
                                                    dtype=np.float64)

        cx, cy, cz = np.meshgrid(np.arange(rx), np.arange(ry), np.arange(rz),
                                 indexing="ij")
        cells = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
        corners = cells[:, None, :] + _CUBE_CORNERS[None].astype(np.int64)
        cube_idx = ((corners[..., 0] * (ry + 1) + corners[..., 1]) * (rz + 1)
                    + corners[..., 2])
        return (_table((verts - 0.5).astype(np.float32), self.device),
                _table(cube_idx.astype(np.int64), self.device))

    # ---------------- topology (sign-dependent) ----------------
    def precompute_topology(self, scalar_field, cube_idx, resolution):
        """The sign-dependent index structure (:class:`_Topology`, on the
        field's device), or None where no cube crosses the surface. Reuse it
        for differentiable geometry while the signs stay."""
        s = torch.as_tensor(scalar_field).detach()
        cube_idx = torch.as_tensor(cube_idx, device=s.device).long()
        device = s.device
        n_verts = s.shape[0]
        occ_n = s < 0
        occ_fx8 = occ_n[cube_idx]
        occ_sum = occ_fx8.sum(-1)
        surf_cubes = (occ_sum > 0) & (occ_sum < 8)
        if not bool(surf_cubes.any()):
            return None

        pow2 = 2 ** torch.arange(8, device=device)
        case_ids = (occ_fx8[surf_cubes] * pow2).sum(-1)
        case_ids = self._resolve_ambiguities(case_ids, surf_cubes, resolution)

        # surface edges
        all_edges = cube_idx[surf_cubes][:, _CUBE_EDGES].reshape(-1, 2)
        unique_edges, _idx_map, counts = unique_pairs(all_edges, n_verts)
        mask_edges = occ_n[unique_edges].sum(-1) == 1
        surf_edges_mask = mask_edges[_idx_map]
        counts = counts[_idx_map]
        idx_map = rank_map(mask_edges)[_idx_map].reshape(-1, 12)
        surf_edges = unique_edges[mask_edges]

        # dual-vertex groups, batched by the number of dual vertices a case
        # has
        dmc = _table(DMC_TABLE, device)
        num_vd = _table(NUM_VD_TABLE, device)[case_ids]
        edge_group, e2vd, e2cube, vd_num_edges, vd_gamma_cube = ([], [], [],
                                                                 [], [])
        total_num_vd = 0
        for num in torch.unique(num_vd).tolist():
            cur_rows = torch.nonzero(num_vd == num)[:, 0]
            grp = dmc[case_ids[cur_rows], :num].reshape(-1, num * 7)
            n_vd = cur_rows.shape[0] * num
            g2vd = (torch.arange(n_vd, device=device)[:, None].expand(n_vd, 7)
                    + total_num_vd).reshape(grp.shape)
            total_num_vd += n_vd
            g2cube = cur_rows[:, None].expand(-1, num * 7)
            m = grp != -1
            edge_group.append(grp[m])
            e2vd.append(g2vd[m])
            e2cube.append(g2cube[m])
            vd_num_edges.append(m.reshape(-1, 7).sum(-1, keepdim=True))
            vd_gamma_cube.append(cur_rows.repeat_interleave(num))
        edge_group = torch.cat(edge_group)
        e2vd = torch.cat(e2vd)
        e2cube = torch.cat(e2cube)
        vd_num_edges = torch.cat(vd_num_edges)
        vd_gamma_cube = torch.cat(vd_gamma_cube)

        # each (cube, edge slot)'s dual vertex
        vd_idx_map = torch.zeros(idx_map.shape[0] * 12, dtype=torch.long,
                                 device=device)
        vd_idx_map[e2cube * 12 + edge_group] = e2vd

        # quads: surface edges shared by 4 surface cubes
        group_mask = (counts == 4) & surf_edges_mask
        group = idx_map.reshape(-1)[group_mask]
        vd_idx = vd_idx_map[group_mask]
        group_sorted, order = torch.sort(group, stable=True)
        edge_indices = group_sorted.reshape(-1, 4)[:, 0]
        quad_vd_idx = vd_idx[order].reshape(-1, 4)
        flip_mask = s[surf_edges[edge_indices, 0]] > 0
        quad_vd_idx = torch.cat([quad_vd_idx[flip_mask][:, [0, 1, 3, 2]],
                                 quad_vd_idx[~flip_mask][:, [2, 3, 1, 0]]])
        quad_s_edge = torch.cat([edge_indices[flip_mask],
                                 edge_indices[~flip_mask]])

        return _Topology(
            surf_cubes=surf_cubes, case_ids=case_ids, surf_edges=surf_edges,
            idx_map=idx_map, edge_group=edge_group, edge_group_to_vd=e2vd,
            edge_group_to_cube=e2cube, vd_num_edges=vd_num_edges,
            vd_gamma_cube=vd_gamma_cube, total_num_vd=int(total_num_vd),
            quad_vd_idx=quad_vd_idx, quad_cube=None, quad_s_edge=quad_s_edge,
            flip_mask=flip_mask)

    def precompute_tet_topology(self, scalar_field, cube_idx, topology,
                                training=False):
        """The index structure of ``output_tetmesh`` (Section 4.5 of the
        paper): (a) a pyramid from each surface quad to the inside endpoint
        of the grid edge it wraps, split along the quad's triangles; (b) for
        each interior grid edge (both endpoints inside) shared by 4 cubes,
        tets from the edge and the dual or centre vertices of consecutive
        cubes around it (TET_TABLE).

        As in the JAX package, each pyramid's apex comes from the quad's own
        edge in the flip-reordered order its faces have (the reference
        kaolin pairs apexes in the order before the reorder)."""
        t = topology
        s = torch.as_tensor(scalar_field).detach()
        device = s.device
        cube_idx = torch.as_tensor(cube_idx, device=device).long()
        occ_n = s < 0
        v_base = t.total_num_vd + (t.quad_vd_idx.shape[0] if training else 0)

        inside_grid_idx = torch.nonzero(occ_n)[:, 0]
        mapping_inside = rank_map(occ_n) + v_base
        mapping_inside = torch.where(occ_n, mapping_inside, -1)

        # (a) surface pyramids, apexes in the faces' order
        quad_edge_verts = t.surf_edges[t.quad_s_edge]              # (Q, 2)
        s_q = s[quad_edge_verts]
        apex_grid = torch.where(s_q[:, 0] < 0, quad_edge_verts[:, 0],
                                quad_edge_verts[:, 1])
        apex_idx = mapping_inside[apex_grid].repeat_interleave(
            4 if training else 2)

        # (b) interior-edge tets
        occ_sum = occ_n[cube_idx].sum(-1)
        inside_cubes = occ_sum == 8
        both = t.surf_cubes | inside_cubes
        n_both = int(both.sum())
        inside_cube_rows = cube_idx[inside_cubes]
        n_inside_c = inside_cube_rows.shape[0]
        center_idx = (torch.arange(n_inside_c, device=device) + v_base
                      + inside_grid_idx.shape[0])

        sc_l = t.surf_cubes[both]
        ic_l = inside_cubes[both]
        vd_idx_map = torch.zeros(t.idx_map.shape[0] * 12, dtype=torch.long,
                                 device=device)
        vd_idx_map[t.edge_group_to_cube * 12 + t.edge_group] = \
            t.edge_group_to_vd
        ecv = torch.full((n_both, 13), -1, dtype=torch.long, device=device)
        ecv[sc_l, :12] = vd_idx_map.reshape(-1, 12)
        ecv[ic_l, 12] = center_idx

        all_edges = cube_idx[both][:, _CUBE_EDGES].reshape(-1, 2)
        unique_edges, inv, counts = unique_pairs(all_edges, s.shape[0])
        interior_edges = occ_n[unique_edges].sum(-1) == 2
        mask = interior_edges[inv]
        counts = counts[inv]
        idx_map2 = rank_map(interior_edges)[inv]

        group_mask = (counts == 4) & mask
        # a stable sort keeps the 4 cubes of an edge in ascending row order:
        # the ring order _ADJ_PAIRS and _DIR_FACES_TABLE assume
        edge_ids_sorted, order = torch.sort(idx_map2[group_mask], stable=True)
        rows = torch.arange(n_both, device=device).repeat_interleave(12)
        slots = torch.arange(12, device=device).repeat(n_both)
        edge2cube = rows[group_mask][order]
        edge_slot = slots[group_mask][order]

        cube_idx_4 = edge2cube.reshape(-1, 4)
        edge_dir = _table(_EDGE_DIR_TABLE, device)[edge_slot][::4]
        shared_faces = _table(_DIR_FACES_TABLE, device)[edge_dir].reshape(-1)
        cube_ring = cube_idx_4[:, _ADJ_PAIRS].reshape(-1)

        case_exp = torch.full((n_both,), 255, dtype=torch.long, device=device)
        case_exp[sc_l] = t.case_ids
        slot_sel = _table(TET_TABLE, device)[case_exp[cube_ring], shared_faces]
        # slot -1 means column 12 (-1 for surface cubes, the centre for
        # inside cubes), as numpy's negative index does
        slot_sel = torch.where(slot_sel < 0, slot_sel + 13, slot_sel)
        quad_edge = ecv[cube_ring, slot_sel].reshape(-1, 2)
        complete = (quad_edge != -1).all(-1)
        inside_edge = mapping_inside[
            unique_edges[interior_edges][edge_ids_sorted]].reshape(-1, 2)
        tets_inside = torch.cat([quad_edge, inside_edge], -1)[complete]

        return _TetTopology(inside_grid_idx=inside_grid_idx,
                            inside_cube_rows=inside_cube_rows,
                            apex_idx=apex_idx, tets_inside=tets_inside)

    def _resolve_ambiguities(self, case_ids, surf_cubes, res):
        """C16/C19 ambiguous-face inversion: a flagged cube whose neighbour
        in its CHECK_TABLE direction is flagged too takes its alternative
        case."""
        if not isinstance(res, (list, tuple)):
            res = [res, res, res]
        rx, ry, rz = (int(r) for r in res)
        device = case_ids.device
        problem_config = _table(CHECK_TABLE, device)[case_ids]
        to_check = problem_config[:, 0] == 1
        problem_config = problem_config[to_check]
        lin = torch.nonzero(surf_cubes)[:, 0][to_check]
        vol_idx_problem = torch.stack([lin // (ry * rz), (lin // rz) % ry,
                                       lin % rz], dim=1)
        full = torch.zeros((rx, ry, rz, 5), dtype=torch.long, device=device)
        full[tuple(vol_idx_problem.T)] = problem_config
        adj = vol_idx_problem + problem_config[:, 1:4]
        bound = torch.tensor([rx, ry, rz], device=device)
        within = ((adj >= 0) & (adj < bound)).all(-1)
        adj = adj[within]
        problem_config = problem_config[within]
        to_invert = full[tuple(adj.T)][:, 0] == 1
        idx = torch.nonzero(to_check)[:, 0][within][to_invert]
        case_ids = case_ids.clone()
        case_ids[idx] = problem_config[to_invert][:, -1]
        return case_ids

    # ---------------- geometry (differentiable) ----------------
    @staticmethod
    def _linear_interp(edges_weight, edges_x):
        """Zero crossing by linear interpolation: edges_weight (..., 2, 1),
        edges_x (..., 2, D)."""
        w = torch.cat([edges_weight[..., 1:2, :],
                       -edges_weight[..., 0:1, :]], dim=-2)
        denom = w.sum(dim=-2)
        return (edges_x * w).sum(dim=-2) / denom

    def __call__(self, voxelgrid_vertices, scalar_field, cube_idx, resolution,
                 qef_reg_scale=1e-3, weight_scale=0.99, beta=None, alpha=None,
                 gamma_f=None, training=False, output_tetmesh=False,
                 grad_func=None, voxelgrid_features=None, topology=None,
                 tet_topology=None):
        """Extract a mesh → (vertices, faces, l_dev), with the dual
        vertices' features appended when ``voxelgrid_features`` is given,
        or (vertices, tets, l_dev) with ``output_tetmesh``. ``topology``
        (:meth:`precompute_topology`) and ``tet_topology``
        (:meth:`precompute_tet_topology`) are computed here when not given.
        ``grad_func`` (the surface's gradient at given points) selects the
        QEF placement, which is not differentiable and gives l_dev 0."""
        device = scalar_field.device
        if topology is None:
            topology = self.precompute_topology(scalar_field, cube_idx,
                                                resolution)
        if topology is None:  # empty surface
            out = (torch.zeros((0, 3), device=device),
                   torch.zeros((0, 4 if output_tetmesh else 3),
                               dtype=torch.long, device=device),
                   torch.zeros((0,), device=device))
            if voxelgrid_features is not None and not output_tetmesh:
                out = out + (torch.zeros((0, voxelgrid_features.shape[-1]),
                                         device=device),)
            return out
        if output_tetmesh and tet_topology is None:
            tet_topology = self.precompute_tet_topology(
                scalar_field, cube_idx, topology, training=training)

        t = topology
        cube_idx = torch.as_tensor(cube_idx, device=device).long()
        n_cubes = cube_idx.shape[0]
        dtype = voxelgrid_vertices.dtype

        # weight normalization
        if beta is not None:
            beta = torch.tanh(beta) * weight_scale + 1
        else:
            beta = torch.ones((n_cubes, 12), dtype=dtype, device=device)
        if alpha is not None:
            alpha = torch.tanh(alpha) * weight_scale + 1
        else:
            alpha = torch.ones((n_cubes, 8), dtype=dtype, device=device)
        if gamma_f is not None:
            gamma_f = torch.sigmoid(gamma_f) * weight_scale \
                + (1 - weight_scale) / 2
        else:
            gamma_f = torch.ones((n_cubes,), dtype=dtype, device=device)
        sc = torch.nonzero(t.surf_cubes)[:, 0]
        beta, alpha, gamma_f = beta[sc], alpha[sc], gamma_f[sc]

        se = t.surf_edges.reshape(-1)
        surf_edges_x = voxelgrid_vertices[se].reshape(-1, 2, 3)
        surf_edges_s = scalar_field[se].reshape(-1, 2, 1)
        zero_crossing = self._linear_interp(surf_edges_s, surf_edges_x)
        if voxelgrid_features is not None:
            nf = voxelgrid_features.shape[-1]
            surf_edges_f = voxelgrid_features[se].reshape(-1, 2, nf)

        alpha_nx12x2 = alpha[:, _CUBE_EDGES].reshape(-1, 12, 2)
        e2vd = t.edge_group_to_vd
        slot = t.edge_group_to_cube * 12 + t.edge_group
        idx_group = t.idx_map.reshape(-1)[slot]

        x_group = surf_edges_x[idx_group]                # (G, 2, 3)
        s_group = surf_edges_s[idx_group]                # (G, 2, 1)
        zc_group = zero_crossing[idx_group]              # (G, 3)
        alpha_group = alpha_nx12x2.reshape(-1, 2)[slot].reshape(-1, 2, 1)
        ue_group = self._linear_interp(s_group * alpha_group, x_group)
        beta_group = beta.reshape(-1)[slot][:, None]

        total_vd = t.total_num_vd
        vd_features = None
        if grad_func is not None:
            # QEF placement: not differentiable, as in the reference
            normals = grad_func(zero_crossing)
            normals = normals / torch.linalg.norm(
                normals, dim=-1, keepdim=True).clamp(min=1e-12)
            vd = self._solve_qef(t, voxelgrid_vertices, cube_idx[sc],
                                 zero_crossing, normals, qef_reg_scale)
            l_dev = torch.zeros((1,), dtype=dtype, device=device)
        else:
            beta_sum = _segment_sum(beta_group, e2vd, total_vd)
            vd = _segment_sum(ue_group * beta_group, e2vd, total_vd) / beta_sum
            # L_dev regularizer
            dist = torch.linalg.norm(zc_group - vd[e2vd], dim=-1)
            mean_l2 = _segment_sum(dist, e2vd, total_vd) \
                / t.vd_num_edges[:, 0].to(dist.dtype)
            l_dev = (dist - mean_l2[e2vd]).abs()
            if voxelgrid_features is not None:
                f_group = surf_edges_f[idx_group]
                uf_group = self._linear_interp(s_group * alpha_group, f_group)
                vd_features = _segment_sum(uf_group * beta_group, e2vd,
                                           total_vd) / beta_sum

        # triangulation
        quad_vd_idx = t.quad_vd_idx
        qv = quad_vd_idx.reshape(-1)
        if grad_func is not None:
            normals_vd = grad_func(vd)
            normals_vd = normals_vd / torch.linalg.norm(
                normals_vd, dim=-1, keepdim=True).clamp(min=1e-12)
            qg = normals_vd[qv].reshape(-1, 4, 3)
            gamma_02 = (qg[:, 0] * qg[:, 2]).sum(-1)
            gamma_13 = (qg[:, 1] * qg[:, 3]).sum(-1)
        else:
            quad_gamma = gamma_f[t.vd_gamma_cube][qv].reshape(-1, 4)
            gamma_02 = quad_gamma[:, 0] * quad_gamma[:, 2]
            gamma_13 = quad_gamma[:, 1] * quad_gamma[:, 3]

        if not training:
            mask = gamma_02 > gamma_13
            faces = torch.where(mask[:, None], quad_vd_idx[:, _QUAD_SPLIT_1],
                                quad_vd_idx[:, _QUAD_SPLIT_2]).reshape(-1, 3)
            vertices = vd
        else:
            vd_quad = vd[qv].reshape(-1, 4, 3)
            vd_02 = (vd_quad[:, 0] + vd_quad[:, 2]) / 2
            vd_13 = (vd_quad[:, 1] + vd_quad[:, 3]) / 2
            weight_sum = gamma_02 + gamma_13 + 1e-8
            vd_center = (vd_02 * gamma_02[:, None]
                         + vd_13 * gamma_13[:, None]) / weight_sum[:, None]
            if vd_features is not None:
                fq = vd_features[qv].reshape(-1, 4, vd_features.shape[-1])
                f02 = (fq[:, 0] + fq[:, 2]) / 2
                f13 = (fq[:, 1] + fq[:, 3]) / 2
                f_center = (f02 * gamma_02[:, None]
                            + f13 * gamma_13[:, None]) / weight_sum[:, None]
                vd_features = torch.cat([vd_features, f_center])
            n_quads = vd_center.shape[0]
            center_idx = torch.arange(n_quads, device=device) + vd.shape[0]
            vertices = torch.cat([vd, vd_center])
            faces = quad_vd_idx[:, _QUAD_SPLIT_TRAIN].reshape(-1, 4, 2)
            faces = torch.cat([faces, center_idx[:, None, None].expand(
                n_quads, 4, 1)], dim=-1).reshape(-1, 3)

        if output_tetmesh:
            tt = tet_topology
            inside_verts = voxelgrid_vertices[tt.inside_grid_idx]
            if tt.inside_cube_rows.shape[0] > 0:
                centers = voxelgrid_vertices[tt.inside_cube_rows].mean(dim=1)
            else:
                centers = vertices.new_zeros((0, 3))
            all_vertices = torch.cat([vertices, inside_verts, centers])
            tets_surface = torch.cat([faces, tt.apex_idx[:, None]], dim=-1)
            return all_vertices, torch.cat([tets_surface, tt.tets_inside]), \
                l_dev

        if voxelgrid_features is not None:
            return vertices, faces, l_dev, vd_features
        return vertices, faces, l_dev

    # ---------------- fixed shapes, no host read ----------------
    @staticmethod
    def static_capacities(resolution, cube_factor=8, edge_factor=4,
                          quad_factor=3):
        """Default capacities of :meth:`jit_extract`: a closed surface in an
        R³ grid crosses O(R²) cubes, so they scale with R² (check them
        against ``aux['counts']``; grow on overflow)."""
        if isinstance(resolution, (list, tuple)):
            resolution = max(resolution)
        r2 = resolution * resolution
        return {"cubes": int(cube_factor * r2),
                "quads": int(quad_factor * r2)}

    @staticmethod
    def suggest_capacities(scalar_field, cube_idx, margin=1.5):
        """Capacities for :meth:`jit_extract` measured from a field: its
        surface-cube count x ``margin`` (quads twice that), rounded up to
        powers of two. Re-check ``aux['counts']`` against them when the
        surface moves a lot."""
        s = torch.as_tensor(scalar_field).detach()
        occ = (s < 0)[torch.as_tensor(cube_idx, device=s.device).long()]
        osum = occ.sum(-1)
        n_surf = int(((osum > 0) & (osum < 8)).sum())

        def pow2(v):
            return 1 << int(np.ceil(np.log2(max(int(v), 64))))
        return {"cubes": pow2(n_surf * margin),
                "quads": pow2(n_surf * margin * 2)}

    def _resolve_ambiguities_device(self, case_full, surf, resolution):
        """C16/C19 inversion over the full cube grid, fixed shapes."""
        if not isinstance(resolution, (list, tuple)):
            resolution = (resolution, resolution, resolution)
        rx, ry, rz = (int(r) for r in resolution)
        c = case_full.shape[0]
        device = case_full.device
        cfg = _table(CHECK_TABLE, device)[case_full]          # (C, 5)
        to_check = (cfg[:, 0] == 1) & surf
        cfg = torch.where(to_check[:, None], cfg, 0)
        lin = torch.arange(c, device=device)
        adj = torch.stack([lin // (rz * ry), (lin // rz) % ry, lin % rz],
                          -1) + cfg[:, 1:4]
        bound = torch.tensor([rx, ry, rz], device=device)
        within = ((adj >= 0) & (adj < bound)).all(-1)
        adj_lin = ((adj[:, 0] * ry + adj[:, 1]) * rz + adj[:, 2]).clamp(
            0, c - 1)
        neighbor_flagged = cfg[:, 0][adj_lin] == 1
        invert = to_check & within & neighbor_flagged
        return torch.where(invert, cfg[:, 4], case_full)

    def jit_extract(self, voxelgrid_vertices, scalar_field, cube_idx,
                    resolution, capacities=None, weight_scale=0.99,
                    beta=None, alpha=None, gamma_f=None, training=False):
        """FlexiCubes with fixed shapes and no host read: topology and
        geometry in one computation on the inputs' device.

        Unlike :meth:`__call__`, dual vertices live in 4 slots a surface
        cube, and the outputs have fixed shapes: vertices ``(4*cap_cubes
        (+cap_quads when training), 3)``, faces ``((2 or 4)*cap_quads,
        3)``; ``aux['face_mask']`` marks real faces,
        ``aux['vertex_mask']`` referenced dual vertices, and
        ``aux['counts']`` the true (surf_cubes, quads) counts beside
        ``aux['capacities']``: a count above its capacity means the outputs
        were cut there, and the caller grows the capacity.

        Gradients flow through scalar_field, vertices and beta/alpha/gamma
        as in :meth:`__call__`.
        """
        caps = dict(self.static_capacities(resolution))
        if capacities:
            caps.update(capacities)
        cap_c, cap_q = int(caps["cubes"]), int(caps["quads"])
        sdf = scalar_field
        device = sdf.device
        cube_idx = torch.as_tensor(cube_idx, device=device).long()
        num_cubes = cube_idx.shape[0]
        n_verts = sdf.shape[0]
        dtype = voxelgrid_vertices.dtype

        occ = sdf < 0
        occ8 = occ[cube_idx]                                   # (C, 8)
        osum = occ8.sum(-1)
        surf = (osum > 0) & (osum < 8)
        case_full = (occ8 * 2 ** torch.arange(8, device=device)).sum(-1)
        case_full = self._resolve_ambiguities_device(case_full, surf,
                                                     resolution)
        n_surf = surf.sum(dtype=torch.int32)

        sel = nonzero_static(surf, cap_c, num_cubes)
        cube_ok = sel < num_cubes
        sel_safe = torch.where(cube_ok, sel, 0)
        rows = cube_idx[sel_safe]                              # (cap_c, 8)
        case_ids = torch.where(cube_ok, case_full[sel_safe], 0)

        # normalized weights at the surface cubes
        if beta is not None:
            beta_s = torch.tanh(beta[sel_safe]) * weight_scale + 1
        else:
            beta_s = torch.ones((cap_c, 12), dtype=dtype, device=device)
        if alpha is not None:
            alpha_s = torch.tanh(alpha[sel_safe]) * weight_scale + 1
        else:
            alpha_s = torch.ones((cap_c, 8), dtype=dtype, device=device)
        if gamma_f is not None:
            gamma_s = torch.sigmoid(gamma_f[sel_safe]) * weight_scale \
                + (1 - weight_scale) / 2
        else:
            gamma_s = torch.ones((cap_c,), dtype=dtype, device=device)

        # each (cube, edge slot)'s endpoints; _CUBE_EDGES orients an edge
        # the same way in every cube, so the pair names the edge, and the
        # flip test reads the field at stored endpoint 0
        edge_pairs = rows[:, _CUBE_EDGES].reshape(cap_c, 12, 2)
        ea, eb = edge_pairs[..., 0], edge_pairs[..., 1]

        # dual vertex of slot k of cube row c: c * 4 + k
        num_vd = _table(NUM_VD_TABLE, device)[case_ids]        # (cap_c,)
        grp = _table(DMC_TABLE, device)[case_ids][:, :4, :]    # (cap_c,4,7)
        kk = torch.arange(4, device=device)[None, :, None]
        entry_ok = ((grp != -1) & (kk < num_vd[:, None, None])
                    & cube_ok[:, None, None])                  # (cap_c,4,7)
        slot = torch.where(entry_ok, grp, 0)
        crow = torch.arange(cap_c, device=device)[:, None, None]
        g_flat = (crow * 12 + slot).reshape(-1)                # (G,)
        e2vd = (crow * 4 + kk).expand(cap_c, 4, 7).reshape(-1)
        gmask = entry_ok.reshape(-1)

        # each occurrence's dual vertex (for quads); invalid entries land in
        # a dump slot that is cut off
        total_vd = cap_c * 4
        vd_of_slot = torch.zeros(cap_c * 12 + 1, dtype=torch.long,
                                 device=device)
        vd_of_slot[torch.where(gmask, g_flat, cap_c * 12)] = e2vd
        vd_of_slot = vd_of_slot[:cap_c * 12]

        # geometry of the group entries
        va = ea.reshape(-1)[g_flat]
        vb = eb.reshape(-1)[g_flat]
        x_group = torch.stack([voxelgrid_vertices[va],
                               voxelgrid_vertices[vb]], dim=1)  # (G, 2, 3)
        s_group = torch.stack([sdf[va], sdf[vb]], dim=1)[..., None]
        zc_group = self._linear_interp(s_group, x_group)
        alpha_12x2 = alpha_s[:, _CUBE_EDGES].reshape(cap_c * 12, 2)
        a_pair = alpha_12x2[g_flat][..., None]
        ue_group = self._linear_interp(s_group * a_pair, x_group)
        beta_group = beta_s.reshape(-1)[g_flat][:, None]
        beta_group = torch.where(gmask[:, None], beta_group, 0.0)

        beta_sum = _segment_sum(beta_group, e2vd, total_vd)
        vd = _segment_sum(ue_group * beta_group, e2vd, total_vd) \
            / beta_sum.clamp(min=1e-12)
        vd_valid = _segment_sum(gmask.long(), e2vd, total_vd) > 0
        # L_dev, masked
        dist = torch.linalg.norm(zc_group - vd[e2vd], dim=-1) * gmask
        vd_cnt = _segment_sum(gmask.to(dist.dtype), e2vd, total_vd)
        mean_l2 = _segment_sum(dist, e2vd, total_vd) / vd_cnt.clamp(min=1.0)
        l_dev = (dist - mean_l2[e2vd]).abs() * gmask

        # ---- quads: the 4 occurrences of each shared surface edge ----
        occ_ok = cube_ok[:, None].expand(cap_c, 12).reshape(-1)
        big = n_verts                   # after every vertex id
        ka = torch.where(occ_ok, ea.reshape(-1), big)
        kb = torch.where(occ_ok, eb.reshape(-1), big)
        # lexsort by (ka, kb, occurrence): a stable sort of one key
        _, order = torch.sort(ka * (big + 1) + kb, stable=True)
        sa, sb = ka[order], kb[order]
        newflag = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                             (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])])
        run_id = torch.cumsum(newflag.long(), 0) - 1
        run_len = torch.bincount(run_id, minlength=cap_c * 12)[run_id]
        # surface edge: exactly one inside endpoint (guard the padding)
        pa = sa.clamp(0, n_verts - 1)
        pb = sb.clamp(0, n_verts - 1)
        is_surf_edge = (occ[pa].long() + occ[pb].long()) == 1
        quad_start = newflag & (run_len == 4) & is_surf_edge & (sa < big)
        n_quads = quad_start.sum(dtype=torch.int32)
        qsel = nonzero_static(quad_start, cap_q, cap_c * 12 - 4)
        qidx = qsel[:, None] + torch.arange(4, device=device)[None, :]
        quad_vd = vd_of_slot[order][qidx]                      # (cap_q, 4)
        # real quads come first, so validity is positional
        quad_ok = torch.arange(cap_q, device=device) < n_quads.clamp(max=cap_q)
        # orientation: the field at the edge's first endpoint
        flip = sdf[pa[qsel]] > 0
        quad_vd = torch.where(flip[:, None], quad_vd[:, [0, 1, 3, 2]],
                              quad_vd[:, [2, 3, 1, 0]])

        # gamma split
        quad_gamma = gamma_s[quad_vd // 4]
        gamma_02 = quad_gamma[:, 0] * quad_gamma[:, 2]
        gamma_13 = quad_gamma[:, 1] * quad_gamma[:, 3]

        if not training:
            msk = gamma_02 > gamma_13
            faces = torch.where(msk[:, None], quad_vd[:, _QUAD_SPLIT_1],
                                quad_vd[:, _QUAD_SPLIT_2]).reshape(-1, 3)
            vertices = vd
            face_mask = quad_ok.repeat_interleave(2)
        else:
            vd_quad = vd[quad_vd.reshape(-1)].reshape(-1, 4, 3)
            vd_02 = (vd_quad[:, 0] + vd_quad[:, 2]) / 2
            vd_13 = (vd_quad[:, 1] + vd_quad[:, 3]) / 2
            wsum = gamma_02 + gamma_13 + 1e-8
            vd_center = (vd_02 * gamma_02[:, None]
                         + vd_13 * gamma_13[:, None]) / wsum[:, None]
            center_idx = torch.arange(cap_q, device=device) + total_vd
            vertices = torch.cat([vd, vd_center])
            faces = quad_vd[:, _QUAD_SPLIT_TRAIN].reshape(-1, 4, 2)
            faces = torch.cat([faces, center_idx[:, None, None].expand(
                cap_q, 4, 1)], dim=-1).reshape(-1, 3)
            face_mask = quad_ok.repeat_interleave(4)
            vd_valid = torch.cat([vd_valid, quad_ok])

        aux = {
            "face_mask": face_mask,
            "vertex_mask": vd_valid,
            "counts": {"surf_cubes": n_surf, "quads": n_quads},
            "capacities": {"surf_cubes": cap_c, "quads": cap_q},
        }
        return vertices, faces, l_dev, aux

    def _solve_qef(self, t, voxelgrid_vertices, surf_rows, zero_crossing,
                   normals, qef_reg_scale):
        """Each dual vertex's QEF solve over its (at most 7) group entries
        in a masked 7-slot layout; ``torch.linalg.lstsq`` by QR (``gels``)
        on every device: the qef_reg_scale·I rows give A full rank."""
        device = zero_crossing.device
        total_vd = t.total_num_vd
        e2vd = t.edge_group_to_vd
        # each entry's slot: its rank among its dual vertex's entries
        sorted_vd, order = torch.sort(e2vd, stable=True)
        first = torch.searchsorted(sorted_vd, sorted_vd)
        slot = torch.empty_like(e2vd)
        slot[order] = torch.arange(e2vd.shape[0], device=device) - first
        idx_group = t.idx_map.reshape(-1)[
            t.edge_group_to_cube * 12 + t.edge_group]
        p_mask = torch.zeros((total_vd, 7), dtype=torch.bool, device=device)
        p_idx = torch.zeros((total_vd, 7), dtype=torch.long, device=device)
        p_mask[e2vd, slot] = True
        p_idx[e2vd, slot] = idx_group
        v0_cube = torch.zeros(total_vd, dtype=torch.long, device=device)
        v0_cube[e2vd] = t.edge_group_to_cube

        p = zero_crossing[p_idx]                              # (V, 7, 3)
        nrm = normals[p_idx]
        msk = p_mask[..., None].to(p.dtype)
        v0 = voxelgrid_vertices[surf_rows[v0_cube][:, 0]]     # (V, 3)
        centroid = (p * msk).sum(dim=1) / msk.sum(dim=1).clamp(min=1)
        eye = torch.eye(3, dtype=p.dtype, device=device) * qef_reg_scale
        A = torch.cat([nrm * msk, eye.expand(total_vd, 3, 3)], dim=1)
        b = torch.cat(
            [((p - v0[:, None]) * nrm).sum(-1, keepdim=True) * msk,
             (qef_reg_scale * (centroid - v0))[..., None]], dim=1)
        sol = torch.linalg.lstsq(A, b, driver="gels").solution[..., 0]
        return sol + v0
