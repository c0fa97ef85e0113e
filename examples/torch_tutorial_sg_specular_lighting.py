"""Tutorial: specular lighting with spherical gaussians, with
kaolin_tpu_torch. The counterpart of
``examples/tutorial_sg_specular_lighting.py``: rasterize per-pixel normals
and view directions, build SG lights, and shade with diffuse plus
Cook-Torrance specular (``sg_warp_specular_term``), sweeping the roughness
to show the highlight tighten.

It runs on the CUDA device, through the winner-search kernel, unless
``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_sg_specular_lighting.py \
        [cuda|cpu] [smoke]
"""

import importlib.util
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.lighting import (
    SgLightingParameters,
    sg_diffuse_inner_product,
    sg_from_sun,
    sg_warp_specular_term,
)


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(device="cuda", smoke=False, res=None):
    """Shade an icosphere with a key and a fill light at three roughnesses
    on ``device`` (the CUDA device unless ``"cpu"`` is named) → {roughness:
    image (H, W, 3), numpy}."""
    res = res or (64 if smoke else 256)
    v, f = _sibling("torch_tutorial_camera_rasterization").make_icosphere(
        2 if smoke else 3)
    vertices = torch.as_tensor(v, device=device)
    faces = torch.as_tensor(f, device=device)
    camera = Camera.from_args(eye=torch.tensor([0.0, 0.6, 2.2],
                                               device=device),
                              at=torch.zeros(3, device=device),
                              up=torch.tensor([0.0, 1.0, 0.0], device=device),
                              fov=0.7, width=res, height=res)
    normals_img, face_idx = _sibling(
        "torch_tutorial_diffuse_lighting").render_normals(camera, vertices,
                                                           faces)
    hit = (face_idx >= 0).cpu().numpy()
    assert hit.any(), "sphere must cover some pixels"

    # a warm key light + a dim cool fill, as SG lobes (sg_from_sun is
    # batched: (N, 3) directions/colors, (N,) strengths/angles)
    sun_dir = torch.tensor([[0.5, 0.7, 0.5], [-0.6, 0.2, 0.4]], device=device)
    sun_dir = sun_dir / torch.linalg.vector_norm(sun_dir, dim=-1,
                                                 keepdim=True)
    amp, direction, sharp = sg_from_sun(
        sun_dir, strength=torch.tensor([3.0, 0.6], device=device),
        angle=torch.tensor([0.3, 0.8], device=device),
        color=torch.tensor([[1.0, 0.95, 0.8], [0.5, 0.6, 1.0]],
                           device=device))
    lights = SgLightingParameters(amplitude=amp, direction=direction,
                                  sharpness=sharp)

    normals = normals_img.reshape(-1, 3)
    nrm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    normals = torch.where(nrm > 1e-6, normals / nrm.clamp(min=1e-6), 0.0)
    cam_pos = camera.cam_pos().reshape(3)
    # per-pixel view direction: surface point ~ sphere normal (unit sphere)
    view = cam_pos[None, :] - normals
    view = view / torch.linalg.vector_norm(view, dim=-1, keepdim=True)

    albedo = torch.tensor([0.6, 0.2, 0.2], device=device)
    diffuse = sg_diffuse_inner_product(
        lights.amplitude, lights.direction, lights.sharpness, normals,
        albedo.expand(normals.shape))

    images = {}
    for rough in ((0.4,) if smoke else (0.15, 0.4, 0.8)):
        spec = sg_warp_specular_term(
            lights.amplitude, lights.direction, lights.sharpness, normals,
            torch.full((normals.shape[0],), rough, device=device), view,
            torch.full(normals.shape, 0.04, device=device))
        img = (diffuse + spec).reshape(res, res, 3).cpu().numpy()
        img = np.where(hit[..., None], img, 0.0)
        images[rough] = img
        assert np.isfinite(img).all()
        assert img[hit].max() > img[hit].mean(), "specular must add contrast"

    if len(images) > 1:
        # rougher surfaces spread the highlight: the max pixel dims while
        # the lit-region mean stays comparable
        peaks = {r: im[hit].max() for r, im in images.items()}
        assert peaks[0.15] > peaks[0.8], f"highlight ordering broke: {peaks}"
    print("sg specular:", {r: float(im[hit].max())
                           for r, im in images.items()})
    return images


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 and sys.argv[1] != "smoke"
         else "cuda", smoke="smoke" in sys.argv[1:])
