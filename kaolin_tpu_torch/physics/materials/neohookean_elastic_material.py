"""Stable Neo-Hookean elasticity (Kim's course formulation), in PyTorch.

Counterpart of ``kaolin_tpu/physics/materials/neohookean_elastic_material.py``:
closed-form energy, gradient and 9x9 Hessian per point, batched over leading
dims.

Energy: ``W = mu/2 (I1 − 3) + lam/2 (J − 1)² − mu (J − 1)``, per point scaled
by its integration volume.
"""

import torch

from kaolin_tpu_torch.physics.materials.material_utils import det_3x3, inv_3x3

__all__ = [
    "neohookean_energy",
    "neohookean_gradient",
    "neohookean_hessian",
    "NeohookeanElasticMaterial",
]


def neohookean_energy(mu, lam, defo_grad, vol=None):
    """Per-point energy; mu, lam (..., 1), F (..., 3, 3) → (..., 1)."""
    C1 = mu / 2.0
    D1 = lam / 2.0
    I1 = torch.sum(defo_grad * defo_grad, dim=(-2, -1))[..., None]
    J = det_3x3(defo_grad)[..., None]
    W = C1 * (I1 - 3.0) + D1 * (J - 1.0) ** 2 - mu * (J - 1.0)
    if vol is not None:
        W = W * vol
    return W


def neohookean_gradient(mu, lam, defo_grad, vol=None):
    """dW/dF per point → (..., 3, 3)."""
    det = det_3x3(defo_grad)
    J = det[..., None, None]
    FinvT = inv_3x3(defo_grad, det=det).transpose(-1, -2)
    mu_ = mu[..., None]
    lam_ = lam[..., None]
    g = mu_ * defo_grad + lam_ * (J - 1.0) * J * FinvT - mu_ * J * FinvT
    if vol is not None:
        g = g * vol[..., None]
    return g


def neohookean_hessian(mu, lam, defo_grad, vol=None):
    """d²W/dF² per point as (..., 9, 9), F flattened row-major.

    H = mu I9 + gamma vec(F^-T)vec(F^-T)ᵀ − dgamma · Π,
    gamma = J(lam(2J−1) − mu), dgamma = gamma − lam J²,
    Π[(i,k),(j,l)] = F^-T[i,l] F^-T[j,k].
    """
    det = det_3x3(defo_grad)
    J = det[..., None]
    FinvT = inv_3x3(defo_grad, det=det).transpose(-1, -2)
    batch = defo_grad.shape[:-2]
    f = FinvT.reshape(batch + (9,))
    gamma = J * (lam * (2.0 * J - 1.0) - mu)
    dgamma = gamma - lam * J * J

    eye9 = torch.eye(9, dtype=defo_grad.dtype, device=defo_grad.device)
    H1 = mu[..., None] * eye9
    ff = f[..., :, None] * f[..., None, :]
    H2 = gamma[..., None] * ff
    # ff[(i*3+l),(j*3+k)] = outer[i, l, j, k] -> H3[i, k, j, l]
    H3 = ff.reshape(batch + (3, 3, 3, 3)).permute(
        *range(len(batch)), *(len(batch) + a for a in (0, 3, 2, 1))
    ).reshape(batch + (9, 9))
    H = H1 + H2 - dgamma[..., None] * H3
    if vol is not None:
        H = H * vol[..., None]
    return H


class NeohookeanElasticMaterial:
    """The defo-grad-wise force of a scene: per-point Lamé parameters and
    integration volumes.

    ``reparameterize_lame=True`` takes lam' = lam + mu, the Stable
    Neo-Hookean reparameterization whose linearization is linear
    elasticity."""

    def __init__(self, mu, lam, integration_pt_volume,
                 reparameterize_lame=False):
        if reparameterize_lame:
            lam = lam + mu
        self.mu = mu.reshape(-1, 1)
        self.lam = lam.reshape(-1, 1)
        self.vol = integration_pt_volume.reshape(-1, 1)

    def energy(self, defo_grad, coeff=1.0):
        """Total energy of F (..., N, 3, 3) → (...)."""
        return coeff * torch.sum(
            neohookean_energy(self.mu, self.lam, defo_grad, self.vol),
            dim=(-2, -1))

    def gradient(self, defo_grad, coeff=1.0):
        return coeff * neohookean_gradient(self.mu, self.lam, defo_grad,
                                           self.vol)

    def hessian(self, defo_grad, coeff=1.0):
        return coeff * neohookean_hessian(self.mu, self.lam, defo_grad,
                                          self.vol)
