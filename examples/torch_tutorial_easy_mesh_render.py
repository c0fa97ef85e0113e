"""Tutorial: SurfaceMesh + one-call rendering (easy_render), with
kaolin_tpu_torch. The counterpart of ``examples/tutorial_easy_mesh_render.py``:
wrap raw arrays in a :class:`~kaolin_tpu_torch.rep.SurfaceMesh`
(auto-computing normals on access), attach a PBR material, and render all
passes with one :func:`~kaolin_tpu_torch.render.easy_render.render_mesh`
call under the default camera and SG lighting.

It runs on the CUDA device, through the winner-search kernel, unless
``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_easy_mesh_render.py \
        [cuda|cpu] [smoke]
"""

import importlib.util
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.render.easy_render import (
    default_camera,
    default_lighting,
    default_material,
    render_mesh,
)
from kaolin_tpu_torch.rep import SurfaceMesh


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(device="cuda", smoke=False):
    """Build, inspect and render an icosphere mesh on ``device`` (the CUDA
    device unless ``"cpu"`` is named) → the rendered image (H, W, 3),
    numpy."""
    res = 48 if smoke else 256
    v, f = _sibling("torch_tutorial_camera_rasterization").make_icosphere(
        1 if smoke else 2)
    vertices = torch.as_tensor(v, device=device)
    faces = torch.as_tensor(f, device=device)

    # --- SurfaceMesh: batching + attribute auto-compute -------------------
    mesh = SurfaceMesh(vertices=vertices, faces=faces)
    print(mesh)
    assert mesh.vertices.shape[0] == vertices.shape[0]

    # accessing face_normals computes them from vertices and faces
    # (per-face-per-vertex (F, 3, 3))
    fn = mesh.face_normals
    assert fn.shape == (faces.shape[0], 3, 3)
    print("auto-computed face_normals:", tuple(fn.shape))
    # vertex normals are averaged from face normals
    vn = mesh.vertex_normals
    assert vn.shape == vertices.shape

    # uvs for texture mapping: spherical projection
    u = 0.5 + torch.arctan2(vertices[:, 2], vertices[:, 0]) / (2 * np.pi)
    w = 0.5 - torch.arcsin(torch.clamp(vertices[:, 1], -1, 1)) / np.pi
    mesh.uvs = torch.stack([u, w], dim=1)
    mesh.face_uvs_idx = faces

    # a default PBR material (diffuse color) on every face
    mesh.materials = [default_material(torch.tensor([0.8, 0.3, 0.2]),
                                       device=device)]
    mesh.material_assignments = torch.zeros(faces.shape[0], dtype=torch.int16,
                                            device=device)

    # --- one-call render ---------------------------------------------------
    camera = default_camera(res, device=device)
    passes = render_mesh(camera, mesh, lighting=default_lighting(device))
    img = passes["render"]
    face_idx = passes["face_idx"]
    covered = int((face_idx >= 0).sum())
    print(f"render passes: {sorted(passes.keys())}")
    print(f"covered pixels: {covered}/{res * res}, "
          f"mean lit value {float(img.mean()):.4f}")
    assert covered > res * res * 0.05
    assert bool(torch.isfinite(img).all())
    assert float(img.max()) > 0

    # the albedo pass carries the material color on covered pixels
    lit = passes["albedo"].reshape(-1, 3)[face_idx.reshape(-1) >= 0]
    np.testing.assert_allclose(lit.max(0).values.cpu().numpy(),
                               [0.8, 0.3, 0.2], atol=0.05)
    print("done")
    return img.cpu().numpy()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 and sys.argv[1] != "smoke"
         else "cuda", smoke="smoke" in sys.argv[1:])
