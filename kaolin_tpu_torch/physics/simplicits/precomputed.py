"""Precomputed dense LBS operators B and dF/dz, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/precomputed.py``. At
Simplicits scale every point touches every handle, so B (3N × 12H) and
dF/dz (9N × 12H) are dense and their products are large matrix products.
The DOF layout is the reference's: z = flatten((H, 3, 4)) row-major, F
flattened row-major (3, 3) → 9. The ``sparse_*`` builders keep the
reference's names and argument orders and return the same dense matrices,
as the JAX package's do.
"""

import torch

__all__ = ["lbs_matrix", "dFdz_matrix", "jacobian_dF_dz",
           "lumped_mass_matrix", "sparse_lbs_matrix", "sparse_dFdz_matrix",
           "sparse_dFdz_matrix_from_dense", "sparse_mass_matrix",
           "sparse_collision_jacobian_matrix"]


def _homogeneous(x0):
    return torch.cat([x0, torch.ones_like(x0[:, :1])], dim=1)


def lbs_matrix(x0, w):
    """Dense LBS Jacobian B with flatten(dx) = B @ flatten(T).

    Args:
        x0: (N, 3) rest points.
        w: (N, H) skinning weights.

    Returns:
        (3N, 12H). Row 3i+r, column 12j+4r+c holds w_ij * [x0_i; 1]_c."""
    n, h = w.shape
    eye3 = torch.eye(3, dtype=x0.dtype, device=x0.device)
    blocks = torch.einsum("nh,nc,rs->nhrsc", w, _homogeneous(x0), eye3)
    return blocks.permute(0, 2, 1, 3, 4).reshape(3 * n, 12 * h)


def dFdz_matrix(w, dwdx, x0):
    """Dense deformation-gradient Jacobian dF/dz, (9N, 12H).

    With x(X) = Σ_j w_j(X) T_j [X;1] + X:
        dF[r,c]/dT_j[r',c'] = delta_{r,r'} (w_j delta_{c'=c, c'<3}
                              + [X;1]_{c'} ∇w_j[c]).

    Args:
        w: (N, H) weights; dwdx: (N, H, 3) their spatial gradients;
        x0: (N, 3) rest points.

    Returns:
        (9N, 12H), F flattened row-major."""
    n, h = w.shape
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device)
    sel3 = torch.zeros((3, 4), dtype=w.dtype, device=w.device)
    sel3[:, :3] = eye3
    term1 = torch.einsum("nh,rp,cq->nhrcpq", w, eye3, sel3)
    term2 = torch.einsum("nhc,nq,rp->nhrcpq", dwdx, _homogeneous(x0), eye3)
    blocks = (term1 + term2).permute(0, 2, 3, 1, 4, 5)
    return blocks.reshape(9 * n, 12 * h)


def jacobian_dF_dz(model, x0, z):
    """dF/dz by automatic differentiation through the skinning function
    (``torch.func``), the oracle of :func:`dFdz_matrix`. ``model`` is a
    skinning module (``compute_skinning_weights``) or a function of points
    → (N, H) weights."""
    num_samples = x0.shape[0]
    fcn = getattr(model, "compute_skinning_weights", model)

    def compute_f(z_flat):
        tfms = z_flat.reshape(1, -1, 3, 4)

        def x_of(p):
            X = p.reshape(-1, 3)
            return (torch.einsum("nh,bhik,nk->nbi", fcn(X), tfms,
                                 _homogeneous(X))[:, 0] + X)[0]

        f = torch.func.vmap(torch.func.jacfwd(x_of))(x0)
        return f.reshape(9 * num_samples)

    return torch.func.jacfwd(compute_f)(z.reshape(-1))


def lumped_mass_matrix(rhos, total_volume, dim=3):
    """Diagonal lumped mass and inverse-mass matrices (3N × 3N) for
    uniformly sampled points with per-point density."""
    rhos = torch.as_tensor(rhos).reshape(-1)
    pt_mass = torch.repeat_interleave(rhos * (total_volume / rhos.shape[0]),
                                      dim)
    return torch.diag(pt_mass), torch.diag(1.0 / pt_mass)


def sparse_lbs_matrix(sim_weights, sim_pts):
    """The LBS Jacobian B (3N × 12H), dense: :func:`lbs_matrix` under the
    reference's name and argument order."""
    return lbs_matrix(sim_pts, sim_weights)


def sparse_dFdz_matrix(sim_weights, sim_weights_jac, sim_pts):
    """dF/dz (9N × 12H), dense: :func:`dFdz_matrix`."""
    return dFdz_matrix(sim_weights, sim_weights_jac, sim_pts)


def sparse_dFdz_matrix_from_dense(enriched_weights_fcn, pts):
    """dF/dz (9N × 12H) by automatic differentiation of the weight function
    ``enriched_weights_fcn`` (points → (N, H) weights)."""
    num_handles = enriched_weights_fcn(pts).shape[1]
    z = pts.new_zeros((num_handles * 12, 1))
    return jacobian_dF_dz(enriched_weights_fcn, pts, z)


def sparse_mass_matrix(sim_rhos):
    """The diagonal 3N × 3N mass matrix of per-point densities, dense."""
    rhos = torch.as_tensor(sim_rhos).reshape(-1)
    return torch.diag(torch.repeat_interleave(rhos, 3))


def sparse_collision_jacobian_matrix(sim_weights, sim_pts, indices,
                                     cp_is_static=None):
    """The LBS Jacobian rows of the collision points ``sim_pts[indices]``,
    dense (3K × 12H); the rows of points whose ``cp_is_static`` is set are
    zero."""
    idx = torch.as_tensor(indices, device=sim_pts.device).reshape(-1).long()
    jac = lbs_matrix(sim_pts[idx], sim_weights[idx])
    if cp_is_static is not None:
        static = torch.as_tensor(cp_is_static,
                                 device=sim_pts.device).reshape(-1)
        keep = torch.repeat_interleave(~static.bool(), 3).to(jac.dtype)
        jac = jac * keep[:, None]
    return jac
