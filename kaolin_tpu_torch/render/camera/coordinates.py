"""World coordinate-system bases. Counterpart of
``kaolin_tpu/render/camera/coordinates.py``. The default kaolin system:
right-handed cartesian, Y up, Z out of the screen."""

import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["blender_coords", "opengl_coords"]


def blender_coords(device=None):
    """Right-handed, Z up; on ``device`` (the CUDA device unless one is
    given)."""
    return torch.tensor([[1, 0, 0], [0, 0, 1], [0, -1, 0]],
                        dtype=torch.float32,
                        device=resolve_device(device, "blender_coords"))


def opengl_coords(device=None):
    """Right-handed, Y up (the identity against the default); on
    ``device`` (the CUDA device unless one is given)."""
    return torch.eye(3, dtype=torch.float32,
                     device=resolve_device(device, "opengl_coords"))
