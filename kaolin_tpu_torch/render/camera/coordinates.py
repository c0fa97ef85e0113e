"""World coordinate-system bases. Counterpart of
``kaolin_tpu/render/camera/coordinates.py``. The default kaolin system:
right-handed cartesian, Y up, Z out of the screen."""

import torch

__all__ = ["blender_coords", "opengl_coords"]


def blender_coords(device="cpu"):
    """Right-handed, Z up."""
    return torch.tensor([[1, 0, 0], [0, 0, 1], [0, -1, 0]],
                        dtype=torch.float32, device=device)


def opengl_coords(device="cpu"):
    """Right-handed, Y up (the identity against the default)."""
    return torch.eye(3, dtype=torch.float32, device=device)
