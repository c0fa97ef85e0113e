"""3D-gaussian transforms: rigid/scaled transforms + SH rotation.

Counterpart of ``kaolin_tpu/ops/gaussians/transforms.py`` (reference
``kaolin/ops/gaussians/transforms.py``, transform_gaussians :63,
transform_shs :125). SH rotation uses the Ivanic-Ruedenberg recurrence (J.
Phys. Chem. 1996) for real-SH Wigner-D matrices, bands 1..3: per-band
sparse tables are built on the host once (numpy, cached) and applied as a
gather-multiply-scatter (``index_add_``) on the tensors' device.
"""

import functools
import math

import numpy as np
import torch

from kaolin_tpu_torch.math.quat.quaternion import quat_from_rot33

__all__ = ["transform_gaussians", "transform_shs"]


def _decompose_4x4(transform):
    """(N, 4, 4) → (translation, rotation (N,3,3), scale (N,3))."""
    translation = transform[:, :3, 3]
    rs = transform[:, :3, :3]
    scale = torch.linalg.vector_norm(rs, dim=1)  # column norms
    rotation = rs / scale[:, None, :]
    return translation, rotation, scale


def _quat_to_mat_wxyz(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _mat_to_quat_wxyz(m):
    q_xyzw = quat_from_rot33(m)
    return torch.cat([q_xyzw[..., 3:4], q_xyzw[..., :3]], dim=-1)


def transform_gaussians(positions, orientations, scales, transform,
                        sh_coeff=None, use_log_scales=False, use_xyzw=False):
    """Apply a 4x4 affine transform to gaussian splats. Quaternions are wxyz
    by default. Returns (positions, orientations, scales, sh_coeff or None)
    on the positions' device. Ref :63."""
    transform = torch.as_tensor(transform).to(positions.device,
                                              positions.dtype)
    if transform.ndim == 2:
        transform = transform[None]
    _, rot, scale = _decompose_4x4(transform)

    ph = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=1)
    new_positions = torch.einsum(
        "nij,nj->ni", transform.expand(positions.shape[0], 4, 4), ph)[:, :3]

    if use_xyzw:
        q_wxyz = torch.cat([orientations[:, 3:4], orientations[:, :3]], dim=1)
    else:
        q_wxyz = orientations
    new_rmat = rot @ _quat_to_mat_wxyz(q_wxyz)
    new_q = _mat_to_quat_wxyz(new_rmat)
    if use_xyzw:
        new_orientations = torch.cat([new_q[:, 1:], new_q[:, :1]], dim=1)
    else:
        new_orientations = new_q

    if use_log_scales:
        new_scales = scales * (torch.log(scale) / scales + 1)
    else:
        new_scales = scales * scale

    if sh_coeff is None:
        return new_positions, new_orientations, new_scales, None
    return (new_positions, new_orientations, new_scales,
            transform_shs(sh_coeff, rot))


# ---------------------------------------------------------------------------
# real-SH Wigner-D rotation (Ivanic & Ruedenberg 1996 recurrence)
# ---------------------------------------------------------------------------

# D^1 = Q R Q^{-1}: permutation [1, 2, 0] with this sign pattern (3DGS real-SH
# basis ordering y, z, x)
_S_3DGS = np.array([[1, -1, 1], [-1, 1, -1], [1, -1, 1]], dtype=np.float64)


@functools.lru_cache(maxsize=8)
def _band_tables(l):
    """Sparse recurrence tables for band l: lists of
    (coeff, out_m, out_n, r1_row, r1_col, prev_row, prev_col)."""
    lm1 = l - 1
    entries = []

    def p_terms(i, a, b):
        ri = i + 1
        if b == l:
            return [(ri, 2, a + lm1, 2 * lm1, 1.0),
                    (ri, 0, a + lm1, 0, -1.0)]
        if b == -l:
            return [(ri, 2, a + lm1, 0, 1.0),
                    (ri, 0, a + lm1, 2 * lm1, 1.0)]
        return [(ri, 1, a + lm1, b + lm1, 1.0)]

    def add(mi, ni, scalar, terms):
        for (rr, rc, pr, pc, s) in terms:
            entries.append((scalar * s, mi, ni, rr, rc, pr, pc))

    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            mi, ni, am = m + l, n + l, abs(m)
            d = float((l + n) * (l - n)) if abs(n) < l else float(2 * l * (2 * l - 1))
            if d == 0:
                continue
            num_u = float((l + m) * (l - m))
            if num_u > 0:
                add(mi, ni, math.sqrt(num_u / d), p_terms(0, m, n))
            if m == 0:
                inner = float(l * (l - 1))
                if inner > 0:
                    add(mi, ni, -0.5 * math.sqrt(2.0 * inner / d),
                        p_terms(1, 1, n) + p_terms(-1, -1, n))
            elif m > 0:
                num_v = float((l + m - 1) * (l + m))
                if num_v > 0:
                    v = 0.5 * math.sqrt(num_v / d)
                    dm1 = 1.0 if m == 1 else 0.0
                    s1, s2 = math.sqrt(1 + dm1), -(1 - dm1)
                    terms = [(rr, rc, pr, pc, s * s1)
                             for rr, rc, pr, pc, s in p_terms(1, m - 1, n)]
                    if abs(s2) > 1e-15:
                        terms += [(rr, rc, pr, pc, s * s2)
                                  for rr, rc, pr, pc, s in p_terms(-1, -m + 1, n)]
                    add(mi, ni, v, terms)
            else:
                num_v = float((l + am - 1) * (l + am))
                if num_v > 0:
                    v = 0.5 * math.sqrt(num_v / d)
                    dm1 = 1.0 if m == -1 else 0.0
                    s1, s2 = (1 - dm1), math.sqrt(1 + dm1)
                    terms = []
                    if abs(s1) > 1e-15:
                        terms += [(rr, rc, pr, pc, s * s1)
                                  for rr, rc, pr, pc, s in p_terms(1, m + 1, n)]
                    terms += [(rr, rc, pr, pc, s * s2)
                              for rr, rc, pr, pc, s in p_terms(-1, -m - 1, n)]
                    add(mi, ni, v, terms)
            if am != 0:
                iw = float((l - am - 1) * (l - am))
                if iw > 0:
                    w = -0.5 * math.sqrt(iw / d)
                    if m > 0:
                        add(mi, ni, w,
                            p_terms(1, m + 1, n) + p_terms(-1, -m - 1, n))
                    else:
                        terms = p_terms(1, m - 1, n)
                        terms += [(rr, rc, pr, pc, -s)
                                  for rr, rc, pr, pc, s in p_terms(-1, -m + 1, n)]
                        add(mi, ni, w, terms)

    arr = np.asarray(entries, dtype=np.float64)
    coeff = arr[:, 0]
    idx = arr[:, 1:].astype(np.int64)
    return coeff, idx


def _apply_wigner(l, d1_pad, d_prev):
    """Band-l Wigner matrix from D^1 (N, 3, 3; rows indexed 0..2 by
    p_terms' row + 1 convention) and D^(l-1)."""
    coeff, idx = _band_tables(l)
    dim = 2 * l + 1
    device = d_prev.device
    coeff_t = torch.as_tensor(coeff, dtype=d_prev.dtype, device=device)
    mi, ni, rr, rc, pr, pc = torch.as_tensor(idx, device=device).unbind(1)
    products = coeff_t[None] * d1_pad[:, rr, rc] * d_prev[:, pr, pc]
    flat = torch.zeros((products.shape[0], dim * dim), dtype=products.dtype,
                       device=device)
    flat.index_add_(1, mi * dim + ni, products)
    return flat.reshape(-1, dim, dim)


def transform_shs(shs_feat, R):
    """Rotate real SH coefficients (bands 0..3, DC passthrough).
    shs_feat (N, (deg+1)², 3); R (N or 1, 3, 3). Ref :125."""
    num_coeffs = shs_feat.shape[1]
    degree = math.isqrt(num_coeffs) - 1
    assert (degree + 1) ** 2 == num_coeffs
    if degree > 3:
        raise NotImplementedError("transform_shs supports degree <= 3")
    R = torch.as_tensor(R).to(shs_feat.device, shs_feat.dtype)
    if R.ndim == 2:
        R = R[None]
    if R.shape[0] == 1 and shs_feat.shape[0] > 1:
        R = R.expand(shs_feat.shape[0], 3, 3)

    parts = [shs_feat[:, :1]]
    if degree >= 1:
        perm = torch.tensor([1, 2, 0], device=R.device)
        s = torch.as_tensor(_S_3DGS, dtype=shs_feat.dtype, device=R.device)
        d1 = R[:, perm][:, :, perm] * s
        parts.append(d1 @ shs_feat[:, 1:4])
    if degree >= 2:
        d2 = _apply_wigner(2, d1, d1)
        parts.append(d2 @ shs_feat[:, 4:9])
    if degree >= 3:
        d3 = _apply_wigner(3, d1, d2)
        parts.append(d3 @ shs_feat[:, 9:16])
    return torch.cat(parts, dim=1)
