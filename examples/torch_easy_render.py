"""The mesh container and the full render with kaolin_tpu_torch: a
two-material :class:`~kaolin_tpu_torch.rep.SurfaceMesh` through
:func:`~kaolin_tpu_torch.render.easy_render.render_mesh` at 512², lit by
one SG light and by 32 lobes fitted to an environment map, a fit step
through the render, and DefTet's all-hits render of the same faces.

- **Scene.** ``uv_sphere(40, 64)`` of ``torch_dibr_optimization.py``
  (2,560 vertices, 4,992 faces) deformed by the texture fit's
  ``target_shape`` and scaled by 0.6, with ``sphere_uvs`` as its
  ``face_uvs`` and the unit sphere's points as ``vertex_features`` (so
  the render has a features pass). Faces whose centroid has y ≥ 0 take
  material 0, the others material 1 (``material_assignments`` int16):

  - material 0, specular workflow: ``checker_texture(256)`` as its diffuse
    texture, a 256² normal map of a sine bump (``bump_normals``), a
    specular color of 0.2 and a roughness of 0.35;
  - material 1, metallic workflow: a diffuse color, ``metallic_value`` 0.7
    and a 256² roughness texture (``roughness_texture``).

  The normal map needs ``face_tangents``, which the mesh computes through
  its whole chain: face normals → vertex normals → vertex tangents → face
  tangents.
- **Render.** ``render_mesh(default_camera(512), mesh,
  default_lighting())``: all ten passes.
- **Environment light.** ``SgLightingParameters.from_environment_map``
  fits 32 lobes to a 256 x 512 sky made in code (``sky_map``); the same
  scene is rendered under them.
- **Fit step.** From a grey texture and ``default_lighting()``, fit the
  vertex offsets, material 0's diffuse texture and the light's amplitude,
  direction and sharpness to a render of the same mesh under another light
  (``TARGET_LIGHT``) with the checker texture: each step sets
  ``mesh.vertices``, renders, takes the mean L1 distance of ``render`` to
  the target, runs backward and steps ``torch.optim.Adam`` (lr 1e-3 for
  the offsets, 3e-2 for the texture, 1e-2 for the light).
- **DefTet.** ``deftet_sparse_render`` of the same faces seen at 512² at
  its defaults (``knum`` 300, ``face_chunk`` 1,024, ``pixel_chunk``
  8,192): 4,992 faces is more than a chunk, so the search streams. Its
  features are the UVs and the camera-space depth.

Everything runs on the CUDA device unless ``cpu`` is named; a CUDA render
launches the winner-search kernel once:

    PYTHONPATH=. python examples/torch_easy_render.py [cuda|cpu] \
        [--steps N] [--res R]
"""

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.mesh import index_vertices_by_faces
from kaolin_tpu_torch.render.easy_render import (
    default_camera,
    default_lighting,
    render_mesh,
)
from kaolin_tpu_torch.render.lighting import (
    SgLightingParameters,
    sg_direction_from_azimuth_elevation,
)
from kaolin_tpu_torch.render.materials import PBRMaterial
from kaolin_tpu_torch.render.mesh import deftet_sparse_render
from kaolin_tpu_torch.rep import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

N_LAT, N_LON = 40, 64
ASSET = (160, 256)          # 81,408 faces: the render at an asset's count
RES = 512
TEX = 256
SCALE = 0.6
ENV = (256, 512)
NUM_SG = 32
STEPS = 100
# Adam's learning rate of each parameter
LR = {"offsets": 1e-3, "texture": 3e-2, "amplitude": 1e-2,
      "direction": 1e-2, "sharpness": 1e-2}
KNUM = 300
METAL_COLOR = (0.75, 0.6, 0.35)
# amplitude, azimuth, elevation, sharpness of the fit's target light
TARGET_LIGHT = ((3.6, 3.2, 2.6), 0.9, 0.7, 7.0)


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bump_normals(size=TEX, waves=8, slope=0.35):
    """A tangent-space normal map of the bump
    sin(2π·waves·u)·sin(2π·waves·v) → (3, size, size) float32 unit vectors
    (x, y, z)."""
    t = 2 * np.pi * waves * (np.arange(size) + 0.5) / size
    du = slope * np.cos(t)[None, :] * np.sin(t)[:, None]
    dv = slope * np.sin(t)[None, :] * np.cos(t)[:, None]
    n = np.stack([-du, -dv, np.ones_like(du)])
    return (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)


def roughness_texture(size=TEX):
    """Roughness rising from 0.2 to 0.8 in bands → (1, size, size)
    float32."""
    ys, xs = np.mgrid[0:size, 0:size] / max(size - 1, 1)
    r = 0.5 + 0.3 * np.sin(6 * np.pi * xs) * np.cos(4 * np.pi * ys)
    return r[None].astype(np.float32)


def sky_map(h=ENV[0], w=ENV[1]):
    """An equirectangular sky (h, w, 3) float32: a blue gradient above the
    horizon, a brown ground below, and a sun at azimuth 40°, elevation
    35°."""
    el = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    az = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    el, az = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.sin(el),
                  np.cos(el) * np.sin(az)], -1)
    up = np.clip(np.sin(el), 0.0, 1.0)[..., None]
    sky = (1 - up) * np.array([0.9, 0.9, 1.0]) + up * np.array([0.2, 0.4,
                                                                0.9])
    ground = np.array([0.25, 0.2, 0.15])
    img = np.where(el[..., None] >= 0, sky, ground)
    sun_el, sun_az = np.radians(35.0), np.radians(40.0)
    sun = np.array([np.cos(sun_el) * np.cos(sun_az), np.sin(sun_el),
                    np.cos(sun_el) * np.sin(sun_az)])
    img = img + 6.0 * np.exp(300.0 * (d @ sun - 1.0))[..., None]
    return img.astype(np.float32)


def scene_arrays(n_lat=N_LAT, n_lon=N_LON, tex=TEX):
    """The scene as numpy arrays: vertices (V, 3), faces (F, 3) int32,
    vertex_features (V, 3) (the unit sphere's points), face_uvs (F, 3, 2),
    material_assignments (F,) int16 and the three textures."""
    base, faces = _sibling("torch_dibr_optimization").uv_sphere(n_lat, n_lon)
    texfit = _sibling("torch_dibr_texture_fit")
    vertices = (texfit.target_shape(base) * np.float32(SCALE)).astype(
        np.float32)
    centroid_y = vertices[faces][:, :, 1].mean(axis=1)
    return {"vertices": vertices, "faces": faces.astype(np.int32),
            "vertex_features": base,
            "face_uvs": texfit.sphere_uvs(n_lat, n_lon),
            "material_assignments": np.where(centroid_y >= 0, 0, 1).astype(
                np.int16),
            "checker": texfit.checker_texture(tex),
            "bump": bump_normals(tex),
            "roughness": roughness_texture(tex)}


def scene(device=None, n_lat=N_LAT, n_lon=N_LON, tex=TEX):
    """The two-material mesh on ``device`` (the CUDA device unless named)."""
    device = resolve_device(device, "scene")
    a = scene_arrays(n_lat, n_lon, tex)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    materials = [
        PBRMaterial(material_name="checker", is_specular_workflow=True,
                    diffuse_texture=t(a["checker"]),
                    normals_texture=t(a["bump"]),
                    specular_color=t(np.full(3, 0.2, np.float32)),
                    roughness_value=t(np.float32(0.35))),
        PBRMaterial(material_name="metal",
                    diffuse_color=t(np.asarray(METAL_COLOR, np.float32)),
                    metallic_value=t(np.float32(0.7)),
                    roughness_texture=t(a["roughness"]))]
    return SurfaceMesh(vertices=t(a["vertices"]), faces=t(a["faces"]),
                       vertex_features=t(a["vertex_features"]),
                       face_uvs=t(a["face_uvs"]),
                       material_assignments=t(a["material_assignments"]),
                       materials=materials)


def render(mesh, lighting=None, res=RES):
    """``render_mesh`` through ``default_camera(res)`` on the mesh's device
    → the dict of passes."""
    device = mesh.vertices.device
    return render_mesh(default_camera(res, device=device), mesh,
                       default_lighting(device) if lighting is None
                       else lighting)


def environment_lighting(device=None, num_sg=NUM_SG, shape=ENV):
    """``num_sg`` lobes fitted to :func:`sky_map`."""
    device = resolve_device(device, "environment_lighting")
    return SgLightingParameters.from_environment_map(
        torch.as_tensor(sky_map(*shape), device=device), num_sg=num_sg)


def env_render(mesh, lighting=None, res=RES):
    """The scene under :func:`environment_lighting` → the passes."""
    if lighting is None:
        lighting = environment_lighting(mesh.vertices.device)
    return render(mesh, lighting, res)


def target_lighting(device):
    """The fit's target light (``TARGET_LIGHT``)."""
    amplitude, azimuth, elevation, sharpness = TARGET_LIGHT
    return SgLightingParameters(
        amplitude=torch.tensor(amplitude, device=device),
        direction=sg_direction_from_azimuth_elevation(azimuth, elevation,
                                                      device=device),
        sharpness=sharpness)


def fit_setup(device=None, res=RES, tex=TEX):
    """A fresh scene, its target render (the checker texture under
    ``target_lighting``, no gradient), and the fit's start: zero offsets,
    a texture of 0.5 as material 0's diffuse texture and
    ``default_lighting()``'s lobe, each a leaf that requires grad, with
    their Adam → the fit's state dict."""
    device = resolve_device(device, "fit_setup")
    mesh = scene(device, tex=tex)
    camera = default_camera(res, device=device)
    with torch.no_grad():
        target = render_mesh(camera, mesh, target_lighting(device))["render"]
    light = default_lighting(device)
    params = {"offsets": torch.zeros_like(mesh.vertices),
              "texture": torch.full((3, tex, tex), 0.5, device=device),
              "amplitude": light.amplitude.clone(),
              "direction": light.direction.clone(),
              "sharpness": light.sharpness.clone()}
    for p in params.values():
        p.requires_grad_(True)
    mesh.materials[0].diffuse_texture = params["texture"]
    return {"mesh": mesh, "camera": camera, "target": target,
            "template": mesh.vertices.detach().clone(), "params": params,
            "opt": torch.optim.Adam([{"params": [p], "lr": LR[k]}
                                     for k, p in params.items()])}


def fit_loss(state):
    """Set ``mesh.vertices`` to the template plus the offsets, render under
    the fitted light → (mean |render − target|, the passes)."""
    p, mesh = state["params"], state["mesh"]
    mesh.vertices = state["template"] + p["offsets"]
    light = SgLightingParameters(amplitude=p["amplitude"],
                                 direction=p["direction"],
                                 sharpness=p["sharpness"])
    out = render_mesh(state["camera"], mesh, light)
    return torch.mean(torch.abs(out["render"] - state["target"])), out


def fit_step(state):
    """One Adam step → the loss before it, detached."""
    state["opt"].zero_grad(set_to_none=True)
    loss, _ = fit_loss(state)
    loss.backward()
    state["opt"].step()
    return loss.detach()


def deftet_inputs(mesh, res=RES):
    """DefTet's inputs for the mesh seen by ``default_camera(res)``: pixel
    coordinates on a res x res grid over [-1, 1]², each pixel's range
    [min z, 0], the faces' camera-space z and image-plane vertices, and
    as features the face UVs and the camera-space depth."""
    device = mesh.vertices.device
    cam = default_camera(res, device=device)
    vc = cam.extrinsics.transform(mesh.vertices[None])
    vi = cam.intrinsics.transform(vc)[..., :2]
    fvz = index_vertices_by_faces(vc, mesh.faces)[..., 2]
    fvi = index_vertices_by_faces(vi, mesh.faces)
    xs = torch.linspace(-1.0, 1.0, res, device=device)
    px, py = torch.meshgrid(xs, xs, indexing="xy")
    pixel_coords = torch.stack([px.reshape(-1), py.reshape(-1)], -1)[None]
    near = fvz.detach().min()
    ranges = torch.stack([near, torch.zeros_like(near)]).expand(
        1, res * res, 2)
    return {"pixel_coords": pixel_coords, "render_ranges": ranges,
            "face_vertices_z": fvz, "face_vertices_image": fvi,
            "face_features": [mesh.face_uvs[None], fvz[..., None]]}


def deftet_render(inputs, knum=KNUM):
    """``deftet_sparse_render`` at its chunk defaults → ((uv features
    (1, P, knum, 2), depths (1, P, knum, 1)), face_idx (1, P, knum))."""
    return deftet_sparse_render(knum=knum, **inputs)


def main(device=None, steps=STEPS, res=RES, verbose=True):
    """Render, light from the environment, fit ``steps`` steps and run
    DefTet on ``device`` (the CUDA device unless ``"cpu"`` is named) →
    dict with the passes, the environment render, the losses and DefTet's
    output."""
    device = resolve_device(device, "main")
    mesh = scene(device)
    passes = render(mesh, res=res)
    env = env_render(mesh, res=res)
    covered = int((passes["face_idx"] >= 0).sum())
    if verbose:
        print(f"render at {res}x{res}: passes {sorted(passes)}; {covered} "
              f"covered pixels, mean {float(passes['render'].mean()):.4f}; "
              f"under {NUM_SG} environment lobes "
              f"{float(env['render'].mean()):.4f}", flush=True)
    state = fit_setup(device, res)
    losses = []
    for i in range(steps):
        losses.append(float(fit_step(state)))
        if verbose and i % 25 == 0:
            print(f"step {i:4d}: L1 {losses[-1]:.5f}", flush=True)
    with torch.no_grad():
        (uv, depth), face_idx = deftet_render(deftet_inputs(mesh, res))
    hits = (face_idx >= 0).sum(-1)
    if verbose:
        print(f"fit: L1 {losses[0]:.5f} -> {losses[-1]:.5f} in {steps} "
              f"steps; DefTet: up to {int(hits.max())} hits a pixel, "
              f"{int((hits > 0).sum())} pixels hit", flush=True)
    return {"passes": passes, "env": env, "losses": losses,
            "deftet": (uv, depth, face_idx)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("device", nargs="?", default=None)
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--res", type=int, default=RES)
    args = parser.parse_args()
    out = main(args.device, args.steps, args.res)
    sys.exit(0 if out["losses"][-1] < 0.5 * out["losses"][0] else 1)
