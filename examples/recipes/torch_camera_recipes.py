"""Camera recipes in the port: construction, properties, transforms,
movement, rays, differentiable pose.

Counterpart of ``examples/recipes/camera_recipes.py``, line for line; on
the card unless ``cpu`` is named. ``torch.autograd`` takes the place of
``jax.grad``.

Run: PYTHONPATH=. python examples/recipes/torch_camera_recipes.py
     [cuda|cpu]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.render.camera import (
    Camera, CameraExtrinsics, PinholeIntrinsics, blender_coords,
    generate_pinhole_rays,
)
from kaolin_tpu_torch.utils.backend import resolve_device


def main(device=None):
    device = resolve_device(device, "the camera recipe")

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def show(x):
        return x.detach().cpu().numpy()

    # -- simple + explicit construction (camera_init_simple/explicit.py) --
    cam = Camera.from_args(eye=t([4.0, 4.0, 4.0]), at=t([0.0, 0.0, 0.0]),
                           up=t([0.0, 1.0, 0.0]),
                           fov=np.deg2rad(45), width=256, height=256)
    explicit = Camera(
        CameraExtrinsics.from_view_matrix(cam.view_matrix()),
        PinholeIntrinsics.from_focal(
            256, 256, focal_x=float(cam.intrinsics.focal_x[0]),
            device=device))
    print("view matrix:\n", show(cam.view_matrix())[0].round(3))

    # -- properties (camera_properties.py) --
    print("fov_y deg:", float(cam.intrinsics.fov()[0]), "| cam_pos:",
          show(cam.cam_pos()).ravel().round(3))

    # -- transforms: world -> camera -> ndc (camera_transforms.py) --
    pts = t(np.random.RandomState(0).randn(5, 3))
    cam_space = cam.extrinsics.transform(pts)
    clip = cam.transform(pts)
    print("world->camera:", tuple(cam_space.shape),
          "world->clip:", tuple(clip.shape))

    # -- movement (camera_movement.py; the API returns new objects) --
    moved = cam.extrinsics.move_forward(1.0).rotate(yaw=0.3)
    print("moved cam_pos:",
          show(Camera(moved, cam.intrinsics).cam_pos()).ravel().round(3))

    # -- coordinate systems (camera_coordinate_systems.py) --
    in_blender = cam.extrinsics.change_coordinate_system(
        blender_coords(device=device))
    print("blender-coords view row0:",
          show(in_blender.view_matrix())[0, 0].round(3))

    # -- ray generation for a ray tracer (camera_ray_tracing.py) --
    ray_o, ray_d = generate_pinhole_rays(cam)
    print("rays:", tuple(ray_o.shape), tuple(ray_d.shape))

    # -- differentiable pose (cameras_differentiable.py): gradients flow
    #    through the extrinsics params --
    target = torch.zeros((5, 3), device=device)

    def loss_fn(extr_params):
        extr = CameraExtrinsics(extr_params, backend=cam.extrinsics.backend)
        projected = Camera(extr, cam.intrinsics).transform(pts)
        return torch.mean((projected[..., :2] - target[None, :, :2]) ** 2)

    params = cam.extrinsics.params.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(params), params)
    print("d loss / d extrinsics params:", tuple(g.shape),
          "finite:", bool(torch.isfinite(g).all()))
    return {"cam": cam, "explicit": explicit, "clip": clip, "grad": g,
            "rays": (ray_o, ray_d)}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
