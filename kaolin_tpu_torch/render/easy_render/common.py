"""Easy-render defaults. Counterpart of
``kaolin_tpu/render/easy_render/common.py``. Each is made on ``device``,
else on the CUDA device; the CPU only when named."""

import math

import torch

from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.lighting import (
    SgLightingParameters,
    sg_direction_from_azimuth_elevation,
)
from kaolin_tpu_torch.render.materials import PBRMaterial
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["default_lighting", "default_camera", "default_material"]


def default_lighting(device=None):
    """Single SG light from upper-left."""
    device = resolve_device(device, "default_lighting")
    direction = sg_direction_from_azimuth_elevation(2.3, math.pi / 3.0,
                                                    device=device)
    return SgLightingParameters(amplitude=3.0, direction=direction,
                                sharpness=5.0)


def default_camera(resolution=512, device=None):
    """Pinhole camera at (1,1,1) looking at origin."""
    device = resolve_device(device, "default_camera")
    return Camera.from_args(
        eye=torch.ones(3, device=device), at=torch.zeros(3, device=device),
        up=torch.tensor([0., 1., 0.], device=device),
        fov=math.pi * 45 / 180, height=resolution, width=resolution,
        device=device)


def default_material(diffuse_color=None, device=None):
    """Slightly specular default PBR material (green)."""
    device = resolve_device(device, "default_material")
    if diffuse_color is None:
        diffuse_color = (118. / 255., 185. / 255., 0.)
    return PBRMaterial(
        diffuse_color=torch.as_tensor(diffuse_color, dtype=torch.float32,
                                      device=device),
        specular_color=torch.tensor((0.2, 0.2, 0.2), device=device),
        roughness_value=torch.tensor(0.5, device=device),
        is_specular_workflow=True)
