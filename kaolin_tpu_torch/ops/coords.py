"""Coordinate-system conversions. Counterpart of ``kaolin_tpu/ops/coords.py``.
Convention: X toward camera, Z-up, Y-right."""

import torch

__all__ = ["spherical2cartesian", "cartesian2spherical"]


def spherical2cartesian(azimuth, elevation, distance=None):
    """Spherical (radians) → cartesian (x, y, z)."""
    z = torch.sin(elevation)
    temp = torch.cos(elevation)
    if distance is not None:
        z = z * distance
        temp = temp * distance
    return torch.cos(azimuth) * temp, torch.sin(azimuth) * temp, z


def cartesian2spherical(x, y, z):
    """Cartesian → (azimuth, elevation, distance) in radians."""
    distance = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    elevation = torch.asin(z / distance)
    azimuth = torch.atan2(y, x)
    return azimuth, elevation, distance
