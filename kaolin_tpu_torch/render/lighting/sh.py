"""Spherical harmonics (degree 3) lighting. Counterpart of
``kaolin_tpu/render/lighting/sh.py``."""

import math

import torch

from kaolin_tpu_torch.utils.backend import input_device

__all__ = ["project_onto_sh9", "sh9_irradiance", "sh9_diffuse"]

# the band factors of the cosine lobe, per coefficient
_BAND_SCALE = [math.pi] + [2.0 * math.pi / 3.0] * 3 + [math.pi / 4.0] * 5


def project_onto_sh9(directions, device=None):
    """Cartesian directions (..., 3) → SH9 coefficients (..., 9). A list
    is made a tensor on ``device``, else on the CUDA device."""
    if not isinstance(directions, torch.Tensor):
        directions = torch.as_tensor(
            directions, dtype=torch.float32,
            device=input_device(None, device, "project_onto_sh9"))
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    return torch.stack([
        torch.full_like(x, 0.28209479177),
        -0.4886025119 * y,
        0.4886025119 * z,
        -0.4886025119 * x,
        1.0925484305920792 * (x * y),
        -1.0925484305920792 * (y * z),
        0.94617469575 * (z * z) - 0.31539156525,
        -1.0925484305920792 * (x * z),
        0.5462742152960396 * (x * x - y * y),
    ], dim=-1)


def sh9_irradiance(lights, normals):
    """Incident irradiance from an SH9 radiance lobe at surface normals:
    lights (9,), normals (N, 3) → (N,)."""
    bands = project_onto_sh9(normals) * normals.new_tensor(_BAND_SCALE)
    return torch.sum(bands * lights[None, :], dim=-1)


def sh9_diffuse(directions, normals, albedo):
    """Lambertian diffuse radiance from an SH9 light in ``directions`` (3,):
    normals/albedo (N, 3) → (N, 3). ``directions`` goes to the normals'
    device."""
    if not isinstance(directions, torch.Tensor):
        directions = torch.as_tensor(directions, dtype=torch.float32)
    lights = project_onto_sh9(directions.to(normals.device))
    irradiance = sh9_irradiance(lights, normals)
    return albedo * irradiance[..., None]
