"""Tutorial: fit a 3D bounding box with the differentiable renderer, with
kaolin_tpu_torch. The counterpart of ``examples/tutorial_bbox_fitting.py``:
recover an object's box from multi-view masks alone, rendering a box mesh
whose centre and log half-extents are the parameters through the soft mask
(``dibr_soft_mask``) and descending a silhouette loss with Adam. The target
masks are an anisotropically scaled icosphere's, rendered by the hard
rasterizer from a ring of cameras, so the recovered box can be checked
against the known extents. The soft mask sharpens from sigmainv 1500 to
7000 to 20000.

It runs on the CUDA device, through the winner search and both soft-mask
kernels, unless ``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_bbox_fitting.py \
        [cuda|cpu] [smoke]
"""

import importlib.util
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.mesh import index_vertices_by_faces
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.mesh import dibr_soft_mask, rasterize

# the unit box about the origin, 12 triangles
BOX_V = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                    for z in (-1, 1)], np.float32)
BOX_F = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
TRUE_CENTER = np.asarray([0.15, 0.1, -0.1], np.float32)
TRUE_HALF = np.asarray([0.55, 0.3, 0.42], np.float32)
SIGMAS = (1500.0, 7000.0, 20000.0)


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cameras(res, n_views, device):
    cams = []
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        eye = torch.tensor([2.6 * np.cos(ang), 1.2, 2.6 * np.sin(ang)],
                           dtype=torch.float32, device=device)
        cams.append(Camera.from_args(
            eye=eye, at=torch.zeros(3, device=device),
            up=torch.tensor([0.0, 1.0, 0.0], device=device), fov=0.9,
            width=res, height=res))
    return cams


def project(camera, vertices, faces):
    """World vertices (V, 3) → per-face image coords (1, F, 3, 2) and
    camera-space z (1, F, 3)."""
    cam_pos = camera.extrinsics.transform(vertices[None])
    ndc = camera.intrinsics.transform(cam_pos)
    face_img = index_vertices_by_faces(ndc[..., :2], faces)
    face_z = index_vertices_by_faces(cam_pos, faces)[..., 2]
    return face_img, face_z


def face_idx_of(camera, face_img, face_z):
    feat = torch.ones(face_img.shape[:2] + (3, 1), device=face_img.device)
    return rasterize(camera.height, camera.width, face_z, face_img, feat)[1]


def hard_mask(camera, vertices, faces):
    face_img, face_z = project(camera, vertices, faces)
    return (face_idx_of(camera, face_img, face_z)[0] >= 0).float()


def main(device="cuda", smoke=False):
    """Fit the box on ``device`` (the CUDA device unless ``"cpu"`` is
    named) and check the loss and the recovered box → {"center",
    "log_half"}."""
    res = 48 if smoke else 128
    n_views = 3 if smoke else 4
    iters = 60 if smoke else 150
    cams = cameras(res, n_views, device)

    sv, sf = _sibling("torch_tutorial_camera_rasterization").make_icosphere(2)
    target_v = torch.as_tensor(sv * TRUE_HALF + TRUE_CENTER, device=device)
    sf = torch.as_tensor(sf, device=device)
    with torch.no_grad():
        target_masks = torch.stack([hard_mask(c, target_v, sf)
                                    for c in cams])

    faces = torch.as_tensor(BOX_F, device=device)
    box_v = torch.as_tensor(BOX_V, device=device)

    def loss_fn(params, sigmainv):
        verts = box_v * torch.exp(params["log_half"]) + params["center"]
        total = 0.0
        for cam, tgt in zip(cams, target_masks):
            face_img, face_z = project(cam, verts, faces)
            with torch.no_grad():
                face_idx = face_idx_of(cam, face_img, face_z)
            soft = dibr_soft_mask(face_img, face_idx, sigmainv=sigmainv,
                                  knum_mode="all")[0]
            total = total + torch.mean((soft - tgt) ** 2)
        return total / len(cams)

    # the start leaves the silhouettes' edges in the frame: a box that fills
    # the image has no edge pixels and so no useful gradient
    params = {"center": torch.zeros(3, device=device),
              "log_half": torch.log(torch.full((3,), 0.6, device=device))}
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=2e-2)
    # coarse to fine: a soft mask reaches far but its halo biases the fit
    # small; ending sharp removes the bias
    losses = []
    for sig in SIGMAS:
        for _ in range(iters // 3 + 1):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, sig)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    center = params["center"].detach().cpu().numpy()
    half = np.exp(params["log_half"].detach().cpu().numpy())
    tol = 0.25 if smoke else 0.15
    assert np.abs(center - TRUE_CENTER).max() < tol, (center, TRUE_CENTER)
    # a box matching a sphere's silhouettes is smaller than the
    # circumscribing box, and the ring of views couples the axes
    lo, hi = (0.45, 1.7) if smoke else (0.55, 1.6)
    assert (half > TRUE_HALF * lo).all() and (half < TRUE_HALF * hi).all(), (
        half, TRUE_HALF)
    print("bbox_fitting:",
          {"center": center.round(3).tolist(),
           "half_extents": half.round(3).tolist(),
           "true_half": TRUE_HALF.tolist(), "loss": losses[-1]})
    return {k: v.detach() for k, v in params.items()}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 and sys.argv[1] != "smoke"
         else "cuda", smoke="smoke" in sys.argv[1:])
