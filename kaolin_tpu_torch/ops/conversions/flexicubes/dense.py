"""Dense FlexiCubes extraction: every quantity on the dense cube grid.

Counterpart of ``kaolin_tpu/ops/conversions/flexicubes/dense.py``: the
FlexiCubes iteration (Shen et al. 2023) computed from shifted **slices** of
the ``(R+1)^3`` scalar field (cube corners, edge endpoints, the cubes around
a quad's edge) and per-case **table rows** (``table[case]``; the tables
hold small integers, so a row index gives what the JAX package's one-hot
matmul gives). Nothing in forward or backward gathers or scatters by data:
the backward of a slice is a pad.

Outputs:

* ``vertices``: ``(R^3 * 4, 3)``, dual-vertex slot ``g`` of cube ``c`` at
  row ``c*4+g`` (+ one quad-centre row a quad when training). Invalid
  slots hold 1.0, not 0: the gradient of ``norm(0)`` is NaN, and a zero
  mask does not stop it in backward.
* ``faces``: int32 ``(2 or 4 a quad, 3)`` rows into ``vertices``, one block
  of quads an edge axis (x, z, y), with ``aux['face_mask']``;
* ``l_dev``: ``(4, 12, R^3)`` masked deviations of each group entry from
  its group's mean distance (the sum equals the compacted paths' sum).

Use :meth:`FlexiCubes.jit_extract` for compact outputs; use this where the
loss works on masked dense arrays (``aux['vd_dense']``,
``aux['vd_valid_dense']``), the usual SDF-optimization inner loop.
"""

import functools

import numpy as np
import torch
from torch.nn import functional as F

from kaolin_tpu_torch.ops.conversions.flexicubes._tables import (
    CHECK_TABLE,
    DMC_TABLE,
    NUM_VD_TABLE,
)

__all__ = ["dense_extract"]

# cube corner k at offset (x, y, z) with k = x + 2y + 4z
_CORNER_OFFS = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
# the cube's 12 edges as corner pairs (x and z edges low → high, y edges
# high → low)
_EDGE_PAIRS = np.array([0, 1, 1, 5, 4, 5, 0, 4, 2, 3, 3, 7, 6, 7, 2, 6,
                        2, 0, 3, 1, 7, 5, 6, 4], dtype=np.int64).reshape(12, 2)
_QUAD_SPLIT_1 = [0, 1, 2, 0, 2, 3]
_QUAD_SPLIT_2 = [0, 1, 3, 3, 1, 2]
_QUAD_SPLIT_TRAIN = [0, 1, 1, 2, 2, 3, 3, 0]
_DIRS = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
         (0, 0, 1)]

# quads: for each edge axis, the 4 cubes around an edge in ascending cube
# order as (cube offset from the edge's low vertex, edge slot in that cube)
_QUAD_NEIGHBORS = {
    # x-edge at vertex (i, j, k): cubes (i, j-1+dy, k-1+dz)
    0: [((0, -1, -1), 6), ((0, -1, 0), 4), ((0, 0, -1), 2), ((0, 0, 0), 0)],
    # z-edge at vertex (i, j, k): cubes (i-1+dx, j-1+dy, k)
    2: [((-1, -1, 0), 5), ((-1, 0, 0), 1), ((0, -1, 0), 7), ((0, 0, 0), 3)],
    # y-edge at vertex (i, j, k): cubes (i-1+dx, j, k-1+dz)
    1: [((-1, 0, -1), 10), ((-1, 0, 0), 9), ((0, 0, -1), 11), ((0, 0, 0), 8)],
}


@functools.lru_cache(maxsize=1)
def _dense_tables():
    """(256, 51) float32 per-case rows: columns 0-47 the group membership
    M[g, e] (4 x 12), columns 48-50 the ambiguity check [to_check, direction
    (0-5), alternative case]."""
    m = np.zeros((256, 4, 12), dtype=np.float32)
    for case in range(256):
        # DMC_TABLE rows beyond num_vd are filler
        for g in range(int(NUM_VD_TABLE[case])):
            for entry in DMC_TABLE[case, g]:
                if entry >= 0:
                    m[case, g, entry] = 1.0
    dir_id = {d: i for i, d in enumerate(_DIRS)}
    chk = np.zeros((256, 3), dtype=np.float32)
    for case in range(256):
        row = CHECK_TABLE[case]
        if row[0] == 1:
            off = (int(row[1]), int(row[2]), int(row[3]))
            chk[case] = [1.0, float(dir_id[off]), float(row[4])]
    return np.concatenate([m.reshape(256, 48), chk], axis=1)


def dense_extract(scalar_field, resolution, beta=None, alpha=None,
                  gamma_f=None, weight_scale=0.99, training=False,
                  grid_origin=-0.5, grid_extent=1.0, _stage=None):
    """FlexiCubes extraction on the dense cube grid, on the field's device.

    Args:
        scalar_field: ``((R+1)^3,)`` SDF samples on the vertex grid of
            :meth:`FlexiCubes.construct_voxel_grid` (x-major order).
        resolution: int R, or an ``(rx, ry, rz)`` tuple.
        beta / alpha / gamma_f: optional ``(R^3, 12) / (R^3, 8) / (R^3,)``
            learnable weights in cube order (the rows of ``cube_idx``).
        training: the quad-centre 4-triangle split (differentiable), else
            the 2-triangle split by the gamma products.
        grid_origin / grid_extent: the vertex grid spans
            ``[origin, origin+extent]^3``.
        _stage: profiling hook: a name among ``case``, ``m``, ``zc``,
            ``vd``, ``ldev`` returns a scalar that depends only on the
            computation up to that stage.

    Returns ``(vertices, faces, l_dev, aux)``; see the module docstring.
    """
    if isinstance(resolution, (tuple, list)):
        rx, ry, rz = (int(r) for r in resolution)
    else:
        rx = ry = rz = int(resolution)
    r3 = rx * ry * rz
    dtype, device = scalar_field.dtype, scalar_field.device
    sdf = scalar_field.reshape(rx + 1, ry + 1, rz + 1)
    table = torch.from_numpy(_dense_tables()).to(device)

    def corner(k):
        x, y, z = _CORNER_OFFS[k]
        return sdf[x:x + rx, y:y + ry, z:z + rz]

    # ---- case ids from the corner signs ----
    case_f = torch.zeros((rx, ry, rz), dtype=dtype, device=device)
    osum_f = torch.zeros((rx, ry, rz), dtype=dtype, device=device)
    for k in range(8):
        bit = (corner(k) < 0).to(dtype)
        case_f = case_f + bit * float(1 << k)
        osum_f = osum_f + bit
    case = case_f.long()
    surf = (osum_f > 0) & (osum_f < 8)
    surf_f = surf.to(dtype)
    if _stage == "case":
        return case_f.sum() + surf_f.sum()

    # ---- C16/C19 ambiguity: a flagged cube whose neighbour in its
    # direction is flagged too takes its alternative case ----
    chk = table[case, 48:51].permute(3, 0, 1, 2)               # (3, R,R,R)
    flagged = (chk[0] > 0.5) & surf
    pad_f = F.pad(flagged.to(dtype), (1, 1, 1, 1, 1, 1))
    dir_id = chk[1].long()
    neighbor_flagged = torch.zeros((rx, ry, rz), dtype=dtype, device=device)
    for d, (dx, dy, dz) in enumerate(_DIRS):
        sl = pad_f[1 + dx:1 + dx + rx, 1 + dy:1 + dy + ry,
                   1 + dz:1 + dz + rz]
        neighbor_flagged = neighbor_flagged + sl * (dir_id == d).to(dtype)
    invert = flagged & (neighbor_flagged > 0.5)
    case = torch.where(invert, chk[2].long(), case)

    # ---- group membership of the (possibly inverted) cases ----
    m = table[case, :48].permute(3, 0, 1, 2).reshape(4, 12, rx, ry, rz)
    m = m * surf_f
    if _stage == "m":
        return m.sum()

    # ---- learnable weights, feature axis first ----
    if alpha is not None:
        alpha_c = torch.tanh(alpha.T.reshape(8, rx, ry, rz)) * weight_scale + 1
    else:
        alpha_c = None
    if beta is not None:
        beta_c = torch.tanh(beta.T.reshape(12, rx, ry, rz)) * weight_scale + 1
    else:
        beta_c = torch.ones((12, rx, ry, rz), dtype=dtype, device=device)
    if gamma_f is not None:
        gamma_c = (torch.sigmoid(gamma_f.reshape(rx, ry, rz)) * weight_scale
                   + (1 - weight_scale) / 2)
    else:
        gamma_c = torch.ones((rx, ry, rz), dtype=dtype, device=device)

    # ---- each edge slot's crossing: base + t * axis vector ----
    h = (float(grid_extent) / rx, float(grid_extent) / ry,
         float(grid_extent) / rz)
    coords = [torch.arange(rx, dtype=dtype, device=device)[:, None, None],
              torch.arange(ry, dtype=dtype, device=device)[None, :, None],
              torch.arange(rz, dtype=dtype, device=device)[None, None, :]]

    def _safe_t(w0, w1):
        denom = w0 - w1
        denom = torch.where(denom.abs() < 1e-12,
                            torch.where(denom < 0, -1e-12, 1e-12), denom)
        return w0 / denom

    zc_l, ue_l = [], []
    for e in range(12):
        c0, c1 = int(_EDGE_PAIRS[e, 0]), int(_EDGE_PAIRS[e, 1])
        s0, s1 = corner(c0), corner(c1)
        o0, o1 = _CORNER_OFFS[c0], _CORNER_OFFS[c1]
        t_plain = _safe_t(s0, s1)
        if alpha_c is None:
            t_w = t_plain
        else:
            t_w = _safe_t(s0 * alpha_c[c0], s1 * alpha_c[c1])
        for t, acc in ((t_plain, zc_l), (t_w, ue_l)):
            xyz = [coords[a] + (o0[a] + t * (o1[a] - o0[a])) if o1[a] != o0[a]
                   else coords[a] + float(o0[a]) for a in range(3)]
            acc.append(torch.stack(
                [(xyz[a] * h[a] + grid_origin).expand(rx, ry, rz)
                 for a in range(3)]))
    zc = torch.stack(zc_l)                                 # (12, 3, R,R,R)
    ue = torch.stack(ue_l) if alpha_c is not None else zc
    if _stage == "zc":
        return zc.sum() + ue.sum()

    # ---- dual vertices: masked weighted means over each group ----
    mb = m * beta_c[None]                                  # (4, 12, R,R,R)
    mb_sum = mb.sum(dim=1)                                 # (4, R,R,R)
    vd = (mb[:, :, None] * ue[None]).sum(dim=1) \
        / mb_sum[:, None].clamp(min=1e-12)                 # (4, 3, R,R,R)
    vd_valid = mb_sum > 0                                  # (4, R,R,R)
    # invalid slots → 1.0 (the norm(0) NaN-gradient guard)
    vd = torch.where(vd_valid[:, None], vd, 1.0)
    if _stage == "vd":
        return vd.sum()

    # ---- L_dev: each entry's deviation from its group's mean distance;
    # the guard keeps sqrt'(0) out of the masked entries' gradient ----
    diff = zc[None] - vd[:, None]                          # (4, 12, 3, R..)
    d2 = (diff * diff).sum(dim=2)                          # (4, 12, R..)
    dist = torch.sqrt(torch.where(m > 0, d2, 1.0)) * m
    cnt = m.sum(dim=1, keepdim=True)                       # (4, 1, R..)
    mean_l2 = dist.sum(dim=1, keepdim=True) / cnt.clamp(min=1.0)
    l_dev = (dist - mean_l2).abs() * m                     # (4, 12, R..)
    if _stage == "ldev":
        return l_dev.sum()

    # ---- quads an edge axis (slices; fixed neighbour patterns) ----
    lin = ((torch.arange(rx, dtype=torch.int32, device=device)[:, None, None]
            * ry + torch.arange(ry, dtype=torch.int32,
                                device=device)[None, :, None]) * rz
           + torch.arange(rz, dtype=torch.int32, device=device)[None, None, :])
    garange = torch.arange(4, dtype=dtype, device=device)[:, None, None, None]

    def quad_axis(axis):
        """Quads around the interior edges of ``axis``, feature axis first:
        (ids (4, Q), gamma (4, Q), flip (Q,), valid (Q,), vd (4, 3, Q))."""
        if axis == 0:    # x-edge at (i, j, k), j, k in [1, R-1]
            nq, base = (rx, ry - 1, rz - 1), (0, 1, 1)
        elif axis == 2:  # z-edge, i, j in [1, R-1]
            nq, base = (rx - 1, ry - 1, rz), (1, 1, 0)
        else:            # y-edge, i, k in [1, R-1]
            nq, base = (rx - 1, ry, rz - 1), (1, 0, 1)

        def cube_view(arr, off):
            i0, j0, k0 = (base[0] + off[0], base[1] + off[1],
                          base[2] + off[2])
            return arr[..., i0:i0 + nq[0], j0:j0 + nq[1], k0:k0 + nq[2]]

        ids, gms, vds, oks = [], [], [], []
        for off, slot in _QUAD_NEIGHBORS[axis]:
            g_oh = cube_view(m[:, slot], off)              # (4, nq)
            vd_n = cube_view(vd, off)                      # (4, 3, nq)
            g_idx = (g_oh * garange).sum(dim=0)            # (nq)
            ids.append(cube_view(lin, off) * 4 + g_idx.to(torch.int32))
            vds.append((g_oh[:, None] * vd_n).sum(dim=0))  # (3, nq)
            gms.append(cube_view(gamma_c, off))
            oks.append(g_oh.sum(dim=0) > 0.5)

        ev = sdf[base[0]:base[0] + nq[0], base[1]:base[1] + nq[1],
                 base[2]:base[2] + nq[2]]                  # low endpoint
        sh = [0, 0, 0]
        sh[axis] = 1
        ev2 = sdf[base[0] + sh[0]:base[0] + sh[0] + nq[0],
                  base[1] + sh[1]:base[1] + sh[1] + nq[1],
                  base[2] + sh[2]:base[2] + sh[2] + nq[2]]
        valid = (ev < 0) != (ev2 < 0)
        s_first = ev2 if axis == 1 else ev     # y edges stored high → low
        for ok in oks:
            valid = valid & ok

        def flat(a):
            return a.reshape(a.shape[:-3] + (-1,))
        return (torch.stack([flat(i) for i in ids]),
                torch.stack([flat(g) for g in gms]),
                flat(s_first) > 0, flat(valid),
                torch.stack([flat(v) for v in vds]))

    parts = [quad_axis(a) for a in (0, 2, 1)]
    q_ids = torch.cat([p[0] for p in parts], dim=1)        # (4, Q)
    q_gm = torch.cat([p[1] for p in parts], dim=1)
    q_flip = torch.cat([p[2] for p in parts])              # (Q,)
    q_ok = torch.cat([p[3] for p in parts])
    q_vd = torch.cat([p[4] for p in parts], dim=2)         # (4, 3, Q)
    nq_total = q_ids.shape[1]
    # orientation: [0, 1, 3, 2] where s_first > 0, else [2, 3, 1, 0]
    perm_a, perm_b = [0, 1, 3, 2], [2, 3, 1, 0]
    q_ids = torch.where(q_flip[None], q_ids[perm_a], q_ids[perm_b])
    q_gm = torch.where(q_flip[None], q_gm[perm_a], q_gm[perm_b])
    q_vd = torch.where(q_flip[None, None], q_vd[perm_a].transpose(0, 1),
                       q_vd[perm_b].transpose(0, 1))       # (3, 4, Q)

    gamma_02 = q_gm[0] * q_gm[2]
    gamma_13 = q_gm[1] * q_gm[3]

    # vertex row c*4+g: (4, 3, rx, ry, rz) → (rx, ry, rz, 4, 3)
    vertices = vd.permute(2, 3, 4, 0, 1).reshape(-1, 3)
    vertex_mask = vd_valid.permute(1, 2, 3, 0).reshape(-1)
    if not training:
        msk = gamma_02 > gamma_13                          # (Q,)
        ft = torch.where(msk[None], q_ids[_QUAD_SPLIT_1],
                         q_ids[_QUAD_SPLIT_2]).reshape(2, 3, nq_total)
        faces = ft.permute(2, 0, 1).reshape(-1, 3)         # rows q*2+t
        face_mask = q_ok.repeat_interleave(2)
    else:
        vd_02 = (q_vd[:, 0] + q_vd[:, 2]) / 2              # (3, Q)
        vd_13 = (q_vd[:, 1] + q_vd[:, 3]) / 2
        wsum = gamma_02 + gamma_13 + 1e-8
        centers = (vd_02 * gamma_02[None]
                   + vd_13 * gamma_13[None]) / wsum[None]  # (3, Q)
        centers = torch.where(q_ok[None], centers, 1.0)    # NaN guard
        center_idx = (torch.arange(nq_total, dtype=torch.int32,
                                   device=device) + r3 * 4)
        vertices = torch.cat([vertices, centers.T])
        vertex_mask = torch.cat([vertex_mask, q_ok])
        t01 = q_ids[_QUAD_SPLIT_TRAIN].reshape(4, 2, nq_total)
        ctr = center_idx[None, None].expand(4, 1, nq_total)
        faces = torch.cat([t01, ctr], dim=1)               # (4, 3, Q)
        faces = faces.permute(2, 0, 1).reshape(-1, 3)      # rows q*4+t
        face_mask = q_ok.repeat_interleave(4)

    aux = {
        "face_mask": face_mask,
        "vertex_mask": vertex_mask,
        "counts": {"surf_cubes": surf.sum(dtype=torch.int32),
                   "quads": q_ok.sum(dtype=torch.int32)},
        # dense views for masked losses without an (N, 3) round trip
        "vd_dense": vd,                                    # (4, 3, R,R,R)
        "vd_valid_dense": vd_valid,                        # (4, R,R,R)
    }
    return vertices, faces, l_dev, aux
