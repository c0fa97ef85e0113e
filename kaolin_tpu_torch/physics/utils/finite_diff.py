"""Central finite-difference Jacobian, in PyTorch.

Counterpart of ``kaolin_tpu/physics/utils/finite_diff.py``.
"""

import math

import torch

__all__ = ["finite_diff_jac"]


def finite_diff_jac(fcn, x, eps=1e-7):
    """Jacobian of ``fcn`` with respect to 3D input positions by central
    differences with step sqrt(eps).

    ``fcn`` maps (6N, dim) stacked probe points → (6N, ...); returns
    (N, ..., dim), the probe axis last."""
    delta = math.sqrt(eps)
    h = delta * torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    bounds = torch.cat([x + h[0], x + h[1], x + h[2],
                        x - h[0], x - h[1], x - h[2]], dim=0)
    jac = fcn(bounds)
    jac = jac.reshape((2, 3, -1) + tuple(jac.shape[1:]))
    jac = (jac[0] - jac[1]) / (2 * delta)
    return torch.movedim(jac, 0, -1)
