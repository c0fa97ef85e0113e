"""Linear blend skinning, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/skinning.py``.
"""

import torch

__all__ = ["weight_function_lbs", "standard_lbs"]


def standard_lbs(x0, tfms, w_x0):
    """x_i = Σ_j w_j(x0_i) T_j [x0_i; 1] + x0_i for a batch of transform sets.

    Args:
        x0: rest points (N, 3).
        tfms: handle transforms (B, H, 3, 4).
        w_x0: skinning weights (N, H).

    Returns:
        (N, B, 1, 3) transformed points (the reference keeps the singleton
        dim)."""
    x0h = torch.cat([x0, torch.ones_like(x0[:, :1])], dim=1)
    x = torch.einsum("nh,bhik,nk->nbi", w_x0, tfms, x0h)
    x = x + x0[:, None, :]
    return x[:, :, None, :]


def weight_function_lbs(x0, tfms, fcn):
    """LBS with the weights ``fcn(x0)`` (differentiable through it)."""
    return standard_lbs(x0, tfms, fcn(x0))
