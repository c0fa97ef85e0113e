"""Ray generation for pinhole and orthographic cameras.

Counterpart of ``kaolin_tpu/render/camera/raygen.py``, in the same op
order.
"""

import torch

from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "generate_default_grid",
    "generate_centered_pixel_coords",
    "generate_centered_custom_resolution_pixel_coords",
    "generate_pinhole_rays",
    "generate_ortho_rays",
    "generate_rays",
]


def generate_default_grid(width, height, dtype=torch.float32, device=None):
    """Pixel-corner grid → (pixel_y, pixel_x), each of shape
    (height, width), on ``device`` (the CUDA device unless one is
    given)."""
    device = resolve_device(device, "generate_default_grid")
    h = torch.arange(height, dtype=dtype, device=device)
    w = torch.arange(width, dtype=dtype, device=device)
    return torch.meshgrid(h, w, indexing="ij")


def generate_centered_pixel_coords(img_width, img_height, dtype=torch.float32,
                                   device=None):
    """Pixel-centre grid → (pixel_y, pixel_x), on ``device`` (the CUDA
    device unless one is given)."""
    device = resolve_device(device, "generate_centered_pixel_coords")
    pixel_y, pixel_x = generate_default_grid(img_width, img_height, dtype,
                                             device)
    return pixel_y + 0.5, pixel_x + 0.5


def generate_centered_custom_resolution_pixel_coords(
        img_width, img_height, res_x=None, res_y=None, dtype=torch.float32,
        device=None):
    """Pixel-centre grid at a custom resolution → (pixel_y, pixel_x), on
    ``device`` (the CUDA device unless one is given)."""
    device = resolve_device(
        device, "generate_centered_custom_resolution_pixel_coords")
    res_x = img_width if res_x is None else res_x
    res_y = img_height if res_y is None else res_y
    scale_x = img_width / res_x
    scale_y = img_height / res_y
    pixel_y, pixel_x = generate_default_grid(res_x, res_y, dtype, device)
    return scale_y * pixel_y + scale_y / 2.0, scale_x * pixel_x + scale_x / 2.0


def _to_ndc_coords(pixel_x, pixel_y, camera):
    pixel_x = 2 * (pixel_x / camera.width) - 1.0
    pixel_y = 2 * (pixel_y / camera.height) - 1.0
    return pixel_x, pixel_y


def _pixel_grid(camera, coords_grid):
    if coords_grid is not None:
        return coords_grid
    return generate_centered_pixel_coords(camera.width, camera.height,
                                          dtype=camera.dtype,
                                          device=camera.extrinsics.device)


def generate_pinhole_rays(camera, coords_grid=None):
    """Rays through the pixel centres of a one-camera pinhole camera →
    (ray_orig (H·W, 3), ray_dir (H·W, 3)) in world coords."""
    if len(camera) != 1:
        raise ValueError("generate_pinhole_rays supports one camera")
    pixel_y, pixel_x = _pixel_grid(camera, coords_grid)
    pixel_x = pixel_x - camera.x0
    pixel_y = pixel_y + camera.y0
    pixel_x, pixel_y = _to_ndc_coords(pixel_x, pixel_y, camera)
    ray_dir = torch.stack(
        (pixel_x * camera.intrinsics.tan_half_fov(CameraFOV.HORIZONTAL),
         -pixel_y * camera.intrinsics.tan_half_fov(CameraFOV.VERTICAL),
         -torch.ones_like(pixel_x)), dim=-1)
    ray_dir = ray_dir.reshape(-1, 3)
    ray_orig = torch.zeros_like(ray_dir)
    ray_orig, ray_dir = camera.extrinsics.inv_transform_rays(ray_orig,
                                                             ray_dir)
    ray_dir = ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1,
                                                 keepdim=True)
    return ray_orig[0], ray_dir[0]


def generate_ortho_rays(camera, coords_grid=None):
    """Parallel rays of a one-camera orthographic camera."""
    if len(camera) != 1:
        raise ValueError("generate_ortho_rays supports one camera")
    pixel_y, pixel_x = _pixel_grid(camera, coords_grid)
    pixel_x, pixel_y = _to_ndc_coords(pixel_x, pixel_y, camera)
    aspect_ratio = camera.width / camera.height
    pixel_x = pixel_x * camera.fov_distance * aspect_ratio
    pixel_y = pixel_y * camera.fov_distance
    zeros = torch.zeros_like(pixel_x)
    ray_dir = torch.stack((zeros, zeros, -torch.ones_like(pixel_x)), dim=-1)
    ray_orig = torch.stack((pixel_x, -pixel_y, zeros), dim=-1)
    ray_orig, ray_dir = camera.extrinsics.inv_transform_rays(
        ray_orig.reshape(-1, 3), ray_dir.reshape(-1, 3))
    return ray_orig[0], ray_dir[0]


def generate_rays(camera, coords_grid=None):
    """Rays of ``camera``, by its lens type."""
    if camera.lens_type == "pinhole":
        return generate_pinhole_rays(camera, coords_grid)
    return generate_ortho_rays(camera, coords_grid)
