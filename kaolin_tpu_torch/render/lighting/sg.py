"""Spherical gaussian lighting: sun lobes, diffuse + Cook-Torrance specular.

Counterpart of ``kaolin_tpu/render/lighting/sg.py``, in PyTorch. The
reduced inner product, a fused CUDA kernel in the reference and a
broadcast-and-sum in JAX, is the same broadcast-and-sum here; autograd
gives the backward. Every clip is :func:`~kaolin_tpu_torch.utils.numerics.
clip`, which splits the gradient at a bound as ``jnp.clip`` does:
background pixels and grazing normals land on those bounds.
"""

import math

import torch

from kaolin_tpu_torch.utils.backend import first_tensor, input_device
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "SgLightingParameters",
    "sg_from_sun",
    "sg_direction_from_azimuth_elevation",
    "sg_distribution_term",
    "sg_warp_distribution",
    "fresnel",
    "sg_warp_specular_term",
    "cosine_lobe_sg",
    "approximate_sg_integral",
    "sg_irradiance_fitted",
    "sg_diffuse_fitted",
    "sg_irradiance_inner_product",
    "sg_diffuse_inner_product",
    "unbatched_sg_inner_product",
    "unbatched_reduced_sg_inner_product",
]


def _to_arr(val, shape, device):
    return torch.as_tensor(val, dtype=torch.float32,
                           device=device).broadcast_to(shape)


class SgLightingParameters:
    """Amplitude/direction/sharpness lobe bundle: ``amplitude`` (n, 3),
    ``direction`` (n, 3) unit, ``sharpness`` (n,), float32.

    The tensors are made on ``device``, else where the first tensor given
    lies, else on the CUDA device (the CPU only when named). Given tensors
    keep their autograd history: a fit may pass its parameters here."""

    def __init__(self, amplitude=3.0, direction=(1.0, 0.0, 0.0),
                 sharpness=5.0, device=None):
        device = input_device(first_tensor(direction, amplitude, sharpness),
                              device, "SgLightingParameters")
        direction = torch.atleast_2d(torch.as_tensor(
            direction, dtype=torch.float32, device=device))
        n = direction.shape[0]
        self.direction = direction / torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True)
        self.amplitude = _to_arr(amplitude, (n, 3), device)
        self.sharpness = _to_arr(sharpness, (n,), device)

    @staticmethod
    def from_sun(direction, strength=3.0, angle=math.pi * 0.25, color=None,
                 device=None):
        """Lobes from sun directions, strengths, angular sizes and
        colors."""
        device = input_device(first_tensor(direction, strength, angle,
                                           color), device,
                              "SgLightingParameters.from_sun")
        direction = torch.atleast_2d(torch.as_tensor(
            direction, dtype=torch.float32, device=device))
        n = direction.shape[0]
        strength = _to_arr(strength, (n,), device)
        angle = _to_arr(angle, (n,), device)
        if color is None:
            color = torch.ones((n, 3), dtype=torch.float32, device=device)
        else:
            color = _to_arr(color, (n, 3), device)
        amplitude, direction, sharpness = sg_from_sun(direction, strength,
                                                      angle, color)
        return SgLightingParameters(amplitude, direction, sharpness)

    @staticmethod
    def from_environment_map(image, num_sg=32, sharpness=None, device=None):
        """Fit SG lobes to an equirectangular environment map (H, W, 3).

        The reference declares this API but leaves it NotImplementedError;
        as in the JAX package: lobe directions on a Fibonacci sphere, broad
        overlapping lobes (sharpness ``num_sg / 6``), per-channel amplitudes
        by solid-angle-weighted linear least squares (the normal equations,
        solved by ``torch.linalg.solve`` on the map's device)."""
        device = input_device(image, device,
                              "SgLightingParameters.from_environment_map")
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        h, w = image.shape[:2]
        # equirect pixel directions (y-up; az in [-pi, pi], el in [-pi/2..])
        el = (0.5 - (torch.arange(h, device=device) + 0.5) / h) * math.pi
        az = ((torch.arange(w, device=device) + 0.5) / w - 0.5) * 2 * math.pi
        ce = torch.cos(el)[:, None]
        dirs = torch.stack([ce * torch.cos(az)[None],
                            torch.sin(el)[:, None].expand(h, w),
                            ce * torch.sin(az)[None]], -1).reshape(-1, 3)
        weights = ce.expand(h, w).reshape(-1)  # solid angle

        # Fibonacci-sphere lobe directions
        k = torch.arange(num_sg, dtype=torch.float32, device=device)
        ga = math.pi * (3.0 - math.sqrt(5.0))
        y = 1.0 - 2.0 * (k + 0.5) / num_sg
        r = torch.sqrt(clip(1.0 - y * y, 0.0))
        lobes = torch.stack([r * torch.cos(ga * k), y, r * torch.sin(ga * k)],
                            -1)
        if sharpness is None:
            # broad, strongly-overlapping lobes condition the fit far better
            # than narrow tiling lobes
            sharpness = num_sg / 6.0
        sharp = torch.full((num_sg,), float(sharpness), dtype=torch.float32,
                           device=device)

        # basis matrix (P, num_sg) and weighted normal equations
        basis = torch.exp(sharp[None] * (dirs @ lobes.T - 1.0))
        bw = basis * weights[:, None]
        ata = basis.T @ bw + 1e-6 * torch.eye(num_sg, device=device)
        atb = bw.T @ image.reshape(-1, 3)
        amplitude = torch.linalg.solve(ata, atb)          # (num_sg, 3)
        return SgLightingParameters(amplitude=amplitude, direction=lobes,
                                    sharpness=sharp)


def sg_from_sun(direction, strength, angle, color):
    """Sun parameters → SG lobe (amplitude, direction, sharpness)."""
    amplitude = color * strength[:, None]
    sharpness = torch.log(0.5 / strength) / (torch.cos(angle / 2) - 1)
    return amplitude, direction, sharpness


def sg_direction_from_azimuth_elevation(azimuth, elevation, device=None):
    """y-up direction (n, 3) from angles (n,). Numbers are made into
    tensors on ``device``, else on the device of a tensor given, else on
    the CUDA device."""
    device = input_device(first_tensor(azimuth, elevation), device,
                          "sg_direction_from_azimuth_elevation")
    azimuth = torch.atleast_1d(torch.as_tensor(azimuth, dtype=torch.float32,
                                               device=device))
    elevation = torch.atleast_1d(torch.as_tensor(
        elevation, dtype=torch.float32, device=device))
    z = torch.sin(elevation)
    temp = torch.cos(elevation)
    x = torch.cos(azimuth) * temp
    y = torch.sin(azimuth) * temp
    return torch.stack([y, z, x], dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _reflect(direction, normal):
    return direction - 2 * _dot(direction, normal) * normal


def _ggx_v1(m2, n_dot_x):
    return 1.0 / (n_dot_x + torch.sqrt(m2 + (1.0 - m2) * n_dot_x * n_dot_x))


def sg_distribution_term(direction, roughness):
    """SG approximation of the GGX NDF."""
    m2 = roughness * roughness
    sharpness = 2.0 / m2
    amplitude = (1.0 / (math.pi * m2))[:, None].expand(direction.shape)
    return amplitude, direction, sharpness


def sg_warp_distribution(amplitude, direction, sharpness, view):
    """Wang et al. warp of the NDF lobe toward the BRDF slice."""
    warp_direction = _reflect(-view, direction)
    warp_sharpness = sharpness / (
        4.0 * clip(_dot(direction, view)[..., 0], 1e-4))
    return amplitude, warp_direction, warp_sharpness


def fresnel(ldh, spec_albedo):
    """Schlick fresnel."""
    return spec_albedo + (1.0 - spec_albedo) * (1.0 - ldh) ** 5


def cosine_lobe_sg(direction):
    """Clamped-cosine lobe as an SG."""
    amplitude = torch.full_like(direction, 1.17)
    sharpness = torch.full_like(direction[..., 0], 2.133)
    return amplitude, direction, sharpness


def approximate_sg_integral(amplitude, sharpness):
    """Whole-sphere SG integral approximation."""
    return 2.0 * math.pi * (amplitude / sharpness[..., None])


def unbatched_sg_inner_product(amplitude, direction, sharpness,
                               other_amplitude, other_direction,
                               other_sharpness):
    """Closed-form inner product of SG pairs → (num_sg, num_other, 3)."""
    a = amplitude[:, None, :]
    d = direction[:, None, :]
    s = sharpness[:, None, None]
    oa = other_amplitude[None, :, :]
    od = other_direction[None, :, :]
    os_ = other_sharpness[None, :, None]
    dm_vec = s * d + os_ * od
    dm = torch.sqrt(clip(_dot(dm_vec, dm_vec), 1e-20))
    lm = s + os_
    expo = torch.exp(dm - lm) * (a * oa)
    other = 1.0 - torch.exp(-2.0 * dm)
    return 2.0 * math.pi * expo * other / dm


def unbatched_reduced_sg_inner_product(amplitude, direction, sharpness,
                                       other_amplitude, other_direction,
                                       other_sharpness):
    """Inner product summed over the 'other' (lights) axis → (num_sg, 3)."""
    return torch.sum(unbatched_sg_inner_product(
        amplitude, direction, sharpness,
        other_amplitude, other_direction, other_sharpness), dim=1)


def sg_irradiance_fitted(amplitude, direction, sharpness, normal):
    """Per-point per-SG irradiance via Stephen Hill's fitted polynomial
    → (num_points, num_sg, 3). Both branches are computed and one chosen
    per point, as in JAX."""
    mu_n = torch.einsum("ik,jk->ij", normal, direction)
    lbda = sharpness[None, :]
    c0 = 0.36
    c1 = 1.0 / (4.0 * c0)
    eml = torch.exp(-lbda)
    em2l = eml * eml
    rl = 1.0 / lbda
    scale = 1.0 + 2.0 * em2l - rl
    bias = (eml - em2l) * rl - em2l
    x = torch.sqrt(clip(1.0 - scale, 1e-12))
    x0 = c0 * mu_n
    x1 = c1 * x
    n = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, n * n / x, clip(mu_n, 0.0, 1.0))
    result = scale * y + bias
    return result[..., None] * approximate_sg_integral(amplitude,
                                                       sharpness)[None]


def sg_diffuse_fitted(amplitude, direction, sharpness, normal, albedo):
    """Lambertian diffuse with fitted irradiance → (num_points, 3)."""
    brdf = albedo / math.pi
    return clip(torch.mean(sg_irradiance_fitted(
        amplitude, direction, sharpness, normal), dim=1), 0.0) * brdf


def sg_irradiance_inner_product(amplitude, direction, sharpness, normal):
    """Irradiance by cosine-lobe SG convolution → (num_points, 3)."""
    lobe_amp, lobe_dir, lobe_sharp = cosine_lobe_sg(normal)
    return clip(unbatched_reduced_sg_inner_product(
        lobe_amp, lobe_dir, lobe_sharp, amplitude, direction, sharpness), 0.0)


def sg_diffuse_inner_product(amplitude, direction, sharpness, normal, albedo):
    """DIB-R++ diffuse reflectance → (num_points, 3)."""
    brdf = albedo / math.pi
    return sg_irradiance_inner_product(amplitude, direction, sharpness,
                                       normal) * brdf


def sg_warp_specular_term(amplitude, direction, sharpness, normal, roughness,
                          view, spec_albedo):
    """Cook-Torrance specular from SG lights → (num_points, 3)."""
    ndf_amp, ndf_dir, ndf_sharp = sg_distribution_term(normal, roughness)
    ndf_amp, ndf_dir, ndf_sharp = sg_warp_distribution(ndf_amp, ndf_dir,
                                                       ndf_sharp, view)
    ndl = clip(_dot(normal, ndf_dir), 0.0, 1.0)
    ndv = clip(_dot(normal, view), 0.0, 1.0)
    h = ndf_dir + view
    h = h / torch.sqrt(clip(_dot(h, h), 1e-20))
    ldh = clip(_dot(ndf_dir, h), 0.0, 1.0)
    output = unbatched_reduced_sg_inner_product(
        ndf_amp, ndf_dir, ndf_sharp, amplitude, direction, sharpness)
    m2 = (roughness * roughness)[:, None]
    output = output * _ggx_v1(m2, ndl) * _ggx_v1(m2, ndv)
    output = output * fresnel(ldh, spec_albedo)
    output = output * ndl
    return clip(output, 0.0)
