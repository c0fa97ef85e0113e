"""Linear elasticity, in PyTorch, batched over leading dims.

Counterpart of ``kaolin_tpu/physics/materials/linear_elastic_material.py``.
"""

import torch

__all__ = [
    "cauchy_strain",
    "linear_elastic_energy",
    "linear_elastic_gradient",
]


def _eye(x):
    return torch.eye(3, dtype=x.dtype, device=x.device)


def cauchy_strain(defo_grad):
    """eps = (F + Fᵀ)/2 − I over (..., 3, 3)."""
    return 0.5 * (defo_grad.transpose(-1, -2) + defo_grad) - _eye(defo_grad)


def linear_elastic_energy(mu, lam, defo_grad):
    """W = mu tr(epsᵀeps) + lam/2 tr(eps)²; mu, lam (..., 1), F
    (..., 3, 3) → (..., 1)."""
    eps = cauchy_strain(defo_grad)
    tr_eps = eps.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None]
    tr_outer = torch.sum(eps * eps, dim=(-2, -1))[..., None]
    return mu * tr_outer + (lam / 2.0) * tr_eps * tr_eps


def linear_elastic_gradient(mu, lam, defo_grad):
    """dW/dF = 2 mu eps + lam tr(eps) I → (..., 3, 3)."""
    eps = cauchy_strain(defo_grad)
    tr_eps = eps.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return 2.0 * mu[..., None] * eps + lam[..., None] * tr_eps * _eye(
        defo_grad)
