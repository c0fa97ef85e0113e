"""DIB-R pose-and-texture fit with kaolin_tpu_torch: BASELINE config 2 as
written, "pose + texture optimization of a textured sample mesh at 512²".

The loop every DIB-R user writes: camera matrices → ``prepare_vertices`` →
``dibr_rasterization`` with UV and mask features → ``texture_mapping`` →
image and silhouette loss → backward into the texture, the vertex offsets
and the pose → Adam. The textured mesh is built in code:

- **Template.** ``uv_sphere`` of ``torch_dibr_optimization.py``, 40 x 64
  (2,560 vertices, 4,992 faces), with per-face UVs u = j/64 and v = i/39
  (the seam column's wrapped corners at u = 1, the first and last latitude
  rings at v = 0 and 1). It starts at the identity pose with zero vertex
  offsets and a 3 x 256 x 256 texture of 0.5.
- **Target.** The same topology with r = 1 + 0.2·sin(2θ)·cos(3φ), scaled by
  (1.0, 0.8, 0.9); an 8 x 8 two-colour checker times a smooth gradient as
  its 3 x 256 x 256 texture; posed by the quaternion of 25° about
  (1, 1, 0)/√2 and translated by (0.1, −0.05, 0). Each view of it is
  rendered once, without gradient, by the same pipeline.
- **Cameras.** A ring of 8 from ``generate_transformation_matrix``:
  distance 3, elevation 20°, azimuths k·45°, looking at the origin with up
  +y; ``generate_perspective_projection(π/3)``. Step s takes B = 2 views,
  2s mod 8 and 2s + 1 mod 8.
- **Forward.** v = rot33_from_quat(quat_unit(q))·(exp(s)·(template +
  offsets)) + t; ``prepare_vertices``; ``dibr_rasterization`` at 512² and
  its defaults (sigmainv 7000, boxlen 0.02, multiplier 1000; faces with
  camera-space normal z ≥ 0 are kept); ``texture_mapping(..., "bilinear")``
  times the rasterized mask.
- **Loss.** mean|I − I*| + ``mask_iou(soft, M*)`` + 0.03·mean‖L·v‖², with
  M* the target's rasterized mask and L the template's
  ``uniform_laplacian``.
- **Optimiser.** ``torch.optim.Adam`` over (texture, offsets, q, t, s), lr
  1e-2, 300 steps by default.

It runs on the CUDA device, through the winner search and both soft-mask
kernels, unless ``cpu`` is named (then through their plain versions):

    PYTHONPATH=. python examples/torch_dibr_texture_fit.py [cuda|cpu] \
        [--steps N] [--res R]
"""

import argparse
import importlib.util
import math
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.math.quat import (
    quat_from_angle_axis,
    quat_unit,
    rot33_from_quat,
)
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.ops.mesh import uniform_laplacian
from kaolin_tpu_torch.render.camera import (
    generate_perspective_projection,
    generate_transformation_matrix,
)
from kaolin_tpu_torch.render.mesh import (
    dibr_rasterization,
    prepare_vertices,
    texture_mapping,
)

N_LAT, N_LON = 40, 64
RES = 512
TEX = 256
VIEWS = 8
BATCH = 2
LR = 1e-2
STEPS = 300
LAP_WEIGHT = 0.03
DISTANCE = 3.0
ELEVATION = math.radians(20.0)
FOVY = math.pi / 3
TARGET_ANGLE = math.radians(25.0)
TARGET_AXIS = (1.0, 1.0, 0.0)
TARGET_T = (0.1, -0.05, 0.0)
TARGET_SCALE = (1.0, 0.8, 0.9)
PARAMS = ("texture", "offsets", "q", "t", "s")


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sphere_uvs(n_lat=N_LAT, n_lon=N_LON):
    """Per-face UVs (F, 3, 2) float32 of ``uv_sphere``'s faces, in their
    order: u = j / n_lon (the seam column's wrapped corners at u = 1),
    v = i / (n_lat - 1)."""
    uvs = []
    for i in range(n_lat - 1):
        v0, v1 = i / (n_lat - 1), (i + 1) / (n_lat - 1)
        for j in range(n_lon):
            u0, u1 = j / n_lon, (j + 1) / n_lon
            uvs.append([[u0, v0], [u1, v0], [u0, v1]])
            uvs.append([[u1, v0], [u1, v1], [u0, v1]])
    return np.asarray(uvs, np.float32)


def checker_texture(size=TEX):
    """An 8 x 8 checker of two colours times a smooth gradient → (3, size,
    size) float32."""
    ys, xs = np.mgrid[0:size, 0:size]
    cell = max(size // 8, 1)
    odd = ((xs // cell + ys // cell) % 2).astype(bool)
    c0 = np.array([0.85, 0.25, 0.15])[:, None, None]
    c1 = np.array([0.15, 0.45, 0.85])[:, None, None]
    ramp = 0.35 + 0.65 * (xs + ys) / (2.0 * max(size - 1, 1))
    return (np.where(odd[None], c1, c0) * ramp[None]).astype(np.float32)


def target_shape(template):
    """The template's unit-sphere vertices (V, 3) at radius 1 +
    0.2·sin(2θ)·cos(3φ), scaled by ``TARGET_SCALE`` → (V, 3) float32."""
    v = template.astype(np.float64)
    theta = np.arccos(np.clip(v[:, 1], -1.0, 1.0))
    phi = np.arctan2(v[:, 2], v[:, 0])
    r = 1.0 + 0.2 * np.sin(2 * theta) * np.cos(3 * phi)
    return (v * r[:, None] * np.asarray(TARGET_SCALE)).astype(np.float32)


def camera_ring():
    """Camera positions (8, 3) float32: distance 3, elevation 20°,
    azimuths k·45°."""
    az = 2 * np.pi * np.arange(VIEWS) / VIEWS
    return np.stack([DISTANCE * np.cos(ELEVATION) * np.sin(az),
                     np.full(VIEWS, DISTANCE * np.sin(ELEVATION)),
                     DISTANCE * np.cos(ELEVATION) * np.cos(az)],
                    -1).astype(np.float32)


def texfit_inputs(n_lat=N_LAT, n_lon=N_LON, tex=TEX):
    """The fit's data as numpy arrays: the template, its faces and UVs, the
    target's shape and texture, the cameras' positions, look-at point and
    up direction, the vertical field of view, and the target pose's
    rotation (angle, axis) and translation."""
    vertices, faces = _sibling("torch_dibr_optimization").uv_sphere(n_lat,
                                                                     n_lon)
    return {
        "template": vertices,
        "faces": faces.astype(np.int64),
        "face_uvs": sphere_uvs(n_lat, n_lon),
        "target_shape": target_shape(vertices),
        "target_texture": checker_texture(tex),
        "cam_pos": camera_ring(),
        "look_at": np.zeros((1, 3), np.float32),
        "up": np.array([[0.0, 1.0, 0.0]], np.float32),
        "fovy": np.float32(FOVY),
        "target_angle": np.array([TARGET_ANGLE], np.float32),
        "target_axis": np.asarray(TARGET_AXIS, np.float32),
        "target_t": np.asarray(TARGET_T, np.float32),
    }


def posed_vertices(template, params):
    """v = R(quat_unit(q))·(exp(s)·(template + offsets)) + t → (V, 3)."""
    rot = rot33_from_quat(quat_unit(params["q"]))
    shape = torch.exp(params["s"]) * (template + params["offsets"])
    return shape @ rot.T + params["t"]


def texfit_render(scene, params, views):
    """Render ``views`` (a list of camera indices) → (image (B, H, W, 3),
    soft mask (B, H, W), rasterized mask (B, H, W), face_idx (B, H, W))."""
    res = scene["res"]
    b = len(views)
    v = posed_vertices(scene["template"], params)
    fvc, fvi, normals = prepare_vertices(
        v[None], scene["faces"], scene["proj"],
        camera_transform=scene["cams"][views])
    uvs = scene["face_uvs"].expand(b, -1, -1, -1)
    (uv_image, mask), soft, face_idx = dibr_rasterization(
        res, res, fvc[..., 2], fvi, [uvs, torch.ones_like(uvs[..., :1])],
        normals[..., 2])
    texture = params["texture"][None].expand(b, -1, -1, -1)
    image = texture_mapping(uv_image, texture, mode="bilinear") * mask
    return image, soft, mask[..., 0], face_idx


def initial_params(scene):
    """The fit's start: a texture of 0.5, zero offsets, the identity pose
    and log-scale 0, each a leaf that requires grad."""
    dev = scene["template"].device
    tex = scene["target_texture"].shape[-1]
    out = {"texture": torch.full((3, tex, tex), 0.5, device=dev),
           "offsets": torch.zeros_like(scene["template"]),
           "q": torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
           "t": torch.zeros(3, device=dev),
           "s": torch.zeros(1, device=dev)}
    for p in out.values():
        p.requires_grad_(True)
    return out


def texfit_setup(inputs, device="cuda", res=RES):
    """Tensors on ``device`` from :func:`texfit_inputs`' arrays, the
    cameras and projection, the template's laplacian, the target pose and
    the target views rendered once without gradient → the scene dict."""
    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    template = t(inputs["template"])
    faces = t(inputs["faces"], torch.long)
    scene = {
        "res": res,
        "template": template,
        "faces": faces,
        "face_uvs": t(inputs["face_uvs"])[None],
        "target_texture": t(inputs["target_texture"]),
        "cams": generate_transformation_matrix(
            t(inputs["cam_pos"]), t(inputs["look_at"]), t(inputs["up"])),
        "proj": generate_perspective_projection(float(inputs["fovy"]),
                                                device=device),
        "laplacian": uniform_laplacian(template.shape[0], faces),
        "target_q": quat_from_angle_axis(t(inputs["target_angle"]),
                                         t(inputs["target_axis"])),
        "target_t": t(inputs["target_t"]),
    }
    target = {"texture": scene["target_texture"],
              "offsets": t(inputs["target_shape"]) - template,
              "q": scene["target_q"], "t": scene["target_t"],
              "s": torch.zeros(1, device=device)}
    with torch.no_grad():
        views = list(range(scene["cams"].shape[0]))
        image, _, mask, _ = texfit_render(scene, target, views)
    scene["target_image"], scene["target_mask"] = image, mask
    return scene


def step_views(step):
    """The views of ``step``: 2·step and 2·step + 1, mod 8."""
    return [(BATCH * step + k) % VIEWS for k in range(BATCH)]


def texfit_loss(scene, params, step):
    """The loss of ``step`` → (loss, {"image", "silhouette", "laplacian"}
    terms, the soft mask, face_idx)."""
    views = step_views(step)
    image, soft, _, face_idx = texfit_render(scene, params, views)
    l_img = torch.mean(torch.abs(image - scene["target_image"][views]))
    l_sil = mask_iou(soft, scene["target_mask"][views])
    lap = scene["laplacian"] @ posed_vertices(scene["template"], params)
    l_lap = LAP_WEIGHT * torch.mean(torch.sum(lap * lap, dim=-1))
    terms = {"image": l_img, "silhouette": l_sil, "laplacian": l_lap}
    return l_img + l_sil + l_lap, terms, soft, face_idx


def make_optimizer(params):
    return torch.optim.Adam([params[k] for k in PARAMS], lr=LR)


def texfit_step(scene, params, opt, step):
    """One Adam step → (the loss before it, its terms), detached."""
    opt.zero_grad(set_to_none=True)
    loss, terms, _, _ = texfit_loss(scene, params, step)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in terms.items()}


def pose_error(scene, params):
    """(the angle in radians between quat_unit(q) and the target
    quaternion, |t − t*|), as tensors."""
    with torch.no_grad():
        dot = torch.abs(torch.sum(quat_unit(params["q"])
                                  * quat_unit(scene["target_q"])))
        angle = 2.0 * torch.arccos(torch.clamp(dot, max=1.0))
        return angle, torch.linalg.vector_norm(params["t"]
                                               - scene["target_t"])


def main(device="cuda", steps=STEPS, res=RES, verbose=True):
    """Fit from the template's start for ``steps`` steps on ``device`` (the
    CUDA device unless ``"cpu"`` is named) → dict with the losses and the
    silhouette terms per step, the pose error (angle, |t − t*|) at the start
    and the end, and the parameters."""
    scene = texfit_setup(texfit_inputs(), device, res)
    params = initial_params(scene)
    opt = make_optimizer(params)
    start = [float(x) for x in pose_error(scene, params)]
    losses, sil = [], []
    for i in range(steps):
        loss, terms = texfit_step(scene, params, opt, i)
        losses.append(loss)
        sil.append(terms["silhouette"])
        if verbose and i % 25 == 0:
            print(f"step {i:4d}: loss {float(loss):.4f} (image "
                  f"{float(terms['image']):.4f}, silhouette "
                  f"{float(terms['silhouette']):.4f}, laplacian "
                  f"{float(terms['laplacian']):.5f})", flush=True)
    end = [float(x) for x in pose_error(scene, params)]
    out = {"losses": [float(x) for x in losses],
           "silhouette": [float(x) for x in sil],
           "pose_error_start": start, "pose_error_end": end,
           "params": params, "scene": scene}
    if verbose:
        print(f"pose error: angle {math.degrees(start[0]):.2f} → "
              f"{math.degrees(end[0]):.2f} deg, |t − t*| {start[1]:.4f} → "
              f"{end[1]:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("device", nargs="?", default="cuda")
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--res", type=int, default=RES)
    args = parser.parse_args(sys.argv[1:])
    main(args.device, args.steps, args.res)
