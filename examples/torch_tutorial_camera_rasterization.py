"""Tutorial: cameras and differentiable rasterization, with
kaolin_tpu_torch. The counterpart of
``examples/tutorial_camera_rasterization.py``: build a pinhole
:class:`~kaolin_tpu_torch.render.camera.Camera` from look-at arguments,
move a mesh into camera and image space, rasterize per-vertex colours, orbit
the camera, and take a gradient through the rasterizer.

It runs on the CUDA device, through the winner-search kernel, unless
``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_camera_rasterization.py \
        [cuda|cpu] [smoke]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.mesh import face_normals, index_vertices_by_faces
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.mesh import rasterize

FOV = np.pi * 45 / 180


def make_icosphere(subdiv=2):
    """An icosahedron on the unit sphere, split ``subdiv`` times at its edge
    midpoints → (vertices (V, 3) float32, faces (F, 3) int64), numpy."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(subdiv):
        mids = {}
        nv = list(v)
        nf = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                m /= np.linalg.norm(m)
                mids[key] = len(nv)
                nv.append(m)
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(nv, np.float32)
        f = np.asarray(nf, np.int64)
    return v, f


def orbit_camera(angle, res, device):
    eye = torch.tensor([2 * np.cos(angle), 1.0, 2 * np.sin(angle)],
                       dtype=torch.float32, device=device)
    return Camera.from_args(eye=eye, at=torch.zeros(3, device=device),
                            up=torch.tensor([0.0, 1.0, 0.0], device=device),
                            fov=FOV, width=res, height=res)


def render(camera, vertices, faces, colors):
    """One differentiable rasterization pass → (image (H, W, 3), face_idx
    (H, W))."""
    cam_pos = camera.extrinsics.transform(vertices)            # (1, V, 3)
    ndc = camera.intrinsics.transform(cam_pos)                 # (1, V, 3)
    face_cam = index_vertices_by_faces(cam_pos, faces)         # (1, F, 3, 3)
    face_ndc = index_vertices_by_faces(ndc[..., :2], faces)
    face_col = index_vertices_by_faces(colors[None], faces)
    image, face_idx = rasterize(camera.height, camera.width,
                                face_cam[..., 2], face_ndc, face_col)
    return image[0], face_idx[0]


def main(device="cuda", smoke=False):
    """Render an icosphere from a look-at camera and three orbit positions,
    check the coverage, a gradient into the colours and the face normals,
    on ``device`` (the CUDA device unless ``"cpu"`` is named) → the last
    image."""
    res = 64 if smoke else 256
    v, f = make_icosphere(1 if smoke else 2)
    vertices = torch.as_tensor(v, device=device)
    faces = torch.as_tensor(f, device=device)
    colors = vertices * 0.5 + 0.5                               # position tint

    camera = Camera.from_args(
        eye=torch.tensor([2.0, 1.0, 2.0], device=device),
        at=torch.zeros(3, device=device),
        up=torch.tensor([0.0, 1.0, 0.0], device=device),
        fov=FOV, width=res, height=res)
    image, face_idx = render(camera, vertices, faces, colors)
    hit = int((face_idx >= 0).sum())
    print(f"frame 0: {hit} covered pixels / {res * res}")
    assert hit > res * res * 0.05

    for i, ang in enumerate(np.linspace(0, np.pi / 2, 4)[1:], 1):
        image, face_idx = render(orbit_camera(ang, res, device), vertices,
                                 faces, colors)
        print(f"frame {i}: {int((face_idx >= 0).sum())} covered pixels")

    colors_g = colors.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        torch.mean(render(camera, vertices, faces, colors_g)[0]), colors_g)
    gn = float(torch.linalg.vector_norm(g))
    print(f"|dL/dcolors| = {gn:.2e}")
    assert np.isfinite(gn) and gn > 0

    fn = face_normals(index_vertices_by_faces(vertices[None], faces),
                      unit=True)[0]
    assert fn.shape == (faces.shape[0], 3)
    print("done")
    return image


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 and sys.argv[1] != "smoke"
         else "cuda", smoke="smoke" in sys.argv[1:])
