"""Tutorial: diffuse lighting with spherical gaussians, with
kaolin_tpu_torch. The counterpart of
``examples/tutorial_diffuse_lighting.py``: rasterize a mesh's normals, build
spherical-gaussian (SG) lights from sun parameters and from azimuth and
elevation, shade the image with both diffuse models (the exact
``sg_irradiance_inner_product`` and the cheaper ``sg_irradiance_fitted``)
and compare them.

It runs on the CUDA device, through the winner-search kernel, unless
``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_diffuse_lighting.py \
        [cuda|cpu] [smoke]
"""

import importlib.util
import math
import os
import sys

import torch

from kaolin_tpu_torch.ops.mesh import face_normals, index_vertices_by_faces
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.lighting import (
    SgLightingParameters,
    sg_diffuse_fitted,
    sg_diffuse_inner_product,
    sg_direction_from_azimuth_elevation,
    sg_from_sun,
)
from kaolin_tpu_torch.render.mesh import rasterize


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_normals(camera, vertices, faces):
    """Rasterize flat per-face normals into a (H, W, 3) image → (image,
    face_idx (H, W))."""
    cam_pos = camera.extrinsics.transform(vertices)            # (1, V, 3)
    ndc = camera.intrinsics.transform(cam_pos)
    face_cam = index_vertices_by_faces(cam_pos, faces)
    face_ndc = index_vertices_by_faces(ndc[..., :2], faces)
    fn = face_normals(index_vertices_by_faces(vertices[None], faces),
                      unit=True)                               # (1, F, 3)
    feat = fn[:, :, None, :].expand(-1, -1, 3, -1)
    image, face_idx = rasterize(camera.height, camera.width,
                                face_cam[..., 2], face_ndc, feat)
    return image[0], face_idx[0]


def main(device="cuda", smoke=False):
    """Shade an icosphere with SG lights on ``device`` (the CUDA device
    unless ``"cpu"`` is named) → the exact diffuse image (H, W, 3),
    numpy."""
    res = 48 if smoke else 256
    v, f = _sibling("torch_tutorial_camera_rasterization").make_icosphere(
        1 if smoke else 2)
    vertices = torch.as_tensor(v, device=device)
    faces = torch.as_tensor(f, device=device)
    camera = Camera.from_args(eye=torch.tensor([2.0, 1.2, 2.0],
                                               device=device),
                              at=torch.zeros(3, device=device),
                              up=torch.tensor([0.0, 1.0, 0.0], device=device),
                              fov=math.pi * 45 / 180, width=res, height=res)
    normals, face_idx = render_normals(camera, vertices, faces)
    hit = face_idx >= 0

    # --- SG lights two ways ---------------------------------------------
    # (a) from sun direction + strength + angular size
    sun = SgLightingParameters.from_sun(
        torch.tensor([-1.0, -1.0, -1.0], device=device) / math.sqrt(3.0),
        strength=2.5, angle=math.pi / 8,
        color=torch.tensor([1.0, 0.9, 0.7], device=device))
    # (b) from azimuth/elevation, through the parameter container
    # easy_render uses (the batched low-level sg_from_sun is importable)
    assert callable(sg_from_sun)
    dir_b = sg_direction_from_azimuth_elevation(2.3, math.pi / 3,
                                                device=device)
    fill = SgLightingParameters(amplitude=1.5, direction=dir_b,
                                sharpness=4.0)
    amplitude = torch.cat([sun.amplitude, fill.amplitude])
    direction = torch.cat([sun.direction, fill.direction])
    sharpness = torch.cat([sun.sharpness, fill.sharpness])

    # --- the exact inner product against the fitted approximation --------
    n_flat = normals.reshape(-1, 3)
    albedo = torch.full_like(n_flat, 0.8)
    img_exact = sg_diffuse_inner_product(amplitude, direction, sharpness,
                                         n_flat, albedo).reshape(res, res, 3)
    img_fit = sg_diffuse_fitted(amplitude, direction, sharpness,
                                n_flat, albedo).reshape(res, res, 3)
    img_exact = torch.where(hit[..., None], img_exact, 0.0)
    img_fit = torch.where(hit[..., None], img_fit, 0.0)

    mean_exact = float(img_exact.sum() / hit.sum().clamp(min=1))
    # the fitted model keeps the shading pattern: compare by correlation
    # over the covered pixels
    a = img_exact.reshape(-1, 3)[hit.reshape(-1)].reshape(-1)
    b = img_fit.reshape(-1, 3)[hit.reshape(-1)].reshape(-1)
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    print(f"lit pixels: {int(hit.sum())}; mean exact radiance "
          f"{mean_exact:.4f}; fitted-vs-exact correlation {corr:.3f}")
    assert mean_exact > 0
    assert corr > 0.9, "fitted approximation should track the inner product"

    lit = int((n_flat @ (-direction[0]) > 0.5).sum())
    print(f"normals facing light (a): {lit}")
    print("done")
    return img_exact.cpu().numpy()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 and sys.argv[1] != "smoke"
         else "cuda", smoke="smoke" in sys.argv[1:])
