"""Simplicits training losses, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/losses.py``: the
orthogonality loss of the sampled weights and the elastic loss, the
finite-difference deformation gradients of the sample points under a batch
of random handle transforms integrated through the linear-to-neohookean
blend of elastic energies. The random draw of a step
(:func:`_draw_batch`) is apart from the evaluation
(:func:`_evaluate_losses`), so that a test can feed the JAX package's draws
through the port's evaluation.
"""

import torch

from kaolin_tpu_torch.physics.materials import (
    linear_elastic_material,
    material_utils,
)
from kaolin_tpu_torch.physics.materials import (
    neohookean_elastic_material as neo,
)
from kaolin_tpu_torch.physics.simplicits.skinning import weight_function_lbs
from kaolin_tpu_torch.physics.utils.finite_diff import finite_diff_jac

__all__ = ["loss_ortho", "loss_elastic", "compute_losses"]


def loss_ortho(weights):
    """Mean squared difference of WᵀW and I over sample weights (S, H)."""
    h = weights.shape[1]
    gram = weights.T @ weights
    eye = torch.eye(h, dtype=weights.dtype, device=weights.device)
    return torch.mean((gram - eye) ** 2)


def loss_elastic(model, pts, yms, prs, rhos, transforms, appx_vol,
                 interp_step, elasticity_type="neohookean",
                 interp_material=False):
    """The Simplicits elastic training loss.

    Moves the sample points ``pts`` (N, 3) by LBS under each of the batch
    of handle transforms ``transforms`` (B, H−1, 3, 4), takes their
    deformation gradients by central differences, and integrates the
    energy blended from linear (``interp_step`` 0) to neohookean (1).
    ``model`` is called raw, on normalized points with the learned handles
    only, as the reference's training does."""
    mus, lams = material_utils.to_lame(yms, prs)
    fs = finite_diff_jac(
        lambda x: weight_function_lbs(x, transforms, model), pts)
    fs = fs[:, :, 0]                                   # (N, B, 3, 3)
    n, b = fs.shape[:2]
    mus = mus.reshape(-1, 1).expand(n, b)[..., None]
    lams = lams.reshape(-1, 1).expand(n, b)[..., None]
    if interp_material:
        mus = (1 - interp_step) * torch.min(mus) + interp_step * mus
        lams = (1 - interp_step) * torch.min(lams) + interp_step * lams
    lin = (1 - interp_step) * linear_elastic_material.linear_elastic_energy(
        mus, lams, fs)
    if elasticity_type != "neohookean":
        raise ValueError(f"elasticity type {elasticity_type} not supported")
    nh = interp_step * neo.neohookean_energy(mus, lams, fs)
    return (appx_vol / pts.shape[0]) * torch.sum(lin + nh)


def _draw_batch(generator, n, num_samples, batch_size, h_learned):
    """A training step's random draw from ``generator``, on its device:
    ``num_samples`` point indices uniform in [0, n) and ``batch_size`` sets
    of ``h_learned`` handle transforms 0.1·N(0, 1) → (sample_indices
    (S,) int64, transforms (B, h_learned, 3, 4) float32)."""
    device = generator.device
    idx = torch.randint(0, n, (num_samples,), generator=generator,
                        device=device)
    tfms = 0.1 * torch.randn((batch_size, h_learned, 3, 4),
                             generator=generator, device=device)
    return idx, tfms


def _evaluate_losses(model, normalized_pts, yms, prs, rhos, en_interp,
                     appx_vol, le_coeff, lo_coeff, sample_indices,
                     transforms):
    """(elastic, ortho) losses at the drawn sample points and transforms
    (from :func:`_draw_batch`, moved to the points' device here)."""
    dev = normalized_pts.device
    idx = sample_indices.to(dev)
    sample_pts = normalized_pts[idx]
    weights = model(sample_pts)
    le = le_coeff * loss_elastic(
        model, sample_pts, yms.reshape(-1)[idx], prs.reshape(-1)[idx],
        rhos.reshape(-1)[idx], transforms.to(dev), appx_vol, en_interp)
    lo = lo_coeff * loss_ortho(weights)
    return le, lo


def compute_losses(model, normalized_pts, yms, prs, rhos, en_interp,
                   batch_size, appx_vol, num_samples, le_coeff, lo_coeff,
                   key):
    """One training step's losses: draw ``num_samples`` points and
    ``batch_size`` random handle transforms from ``key`` (a
    ``torch.Generator``), return (elastic, ortho) losses."""
    with torch.no_grad():
        h_learned = model(normalized_pts[:1]).shape[-1]
    sample_indices, transforms = _draw_batch(
        key, normalized_pts.shape[0], num_samples, batch_size, h_learned)
    return _evaluate_losses(model, normalized_pts, yms, prs, rhos, en_interp,
                            appx_vol, le_coeff, lo_coeff, sample_indices,
                            transforms)
