"""DIB-R inverse rendering with kaolin_tpu_torch: silhouette pose
optimisation, the PyTorch counterpart of ``examples/dibr_optimization.py``.

``main`` optimises a triangle's vertex positions so that its rendered soft
silhouette matches a target mask. ``config2_step`` is the 512² UV-sphere
optimisation step of BASELINE config 2: rasterize features and the soft
mask, loss ``sum(img²) + sum(soft²)``, gradients with respect to
``face_vertices_image`` and ``face_features``, gradient-descent updates.

On a CUDA device both run through the hand-written kernels; on the CPU
through their plain PyTorch versions.

Run from the repository root:
    PYTHONPATH=. python examples/torch_dibr_optimization.py [cpu|cuda]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.render.mesh import dibr_rasterization
from kaolin_tpu_torch.utils.interop import from_numpy_tree


def triangle(shift, device):
    fvi = torch.tensor([[[[-0.4 + shift, -0.4], [0.4 + shift, -0.4],
                          [0.0 + shift, 0.45]]]], device=device)
    fvz = torch.full((1, 1, 3), -1.0, device=device)
    feat = torch.ones((1, 1, 3, 3), device=device)
    return fvz, fvi, feat


def optimize(device="cpu", res=64, iters=60, verbose=False):
    """Move a triangle shifted by 0.45 in x onto the silhouette of the
    unshifted one with Adam (lr 2e-2). Returns (loss per step, final
    ``face_vertices_image`` (1, 1, 3, 2))."""
    fvz, fvi_target, feat = triangle(0.0, device)
    nz = torch.ones((1, 1), device=device)
    with torch.no_grad():
        _, target_mask, _ = dibr_rasterization(res, res, fvz, fvi_target,
                                               feat, nz)
    target = (target_mask > 0.5).float()
    fvi = triangle(0.45, device)[1].requires_grad_(True)
    opt = torch.optim.Adam([fvi], lr=2e-2)
    losses = []
    for it in range(iters):
        opt.zero_grad(set_to_none=True)
        _, soft, _ = dibr_rasterization(res, res, fvz, fvi, feat, nz,
                                        sigmainv=70, boxlen=0.5)
        loss = mask_iou(soft, target)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and it % 15 == 0:
            print(f"iter {it:3d}: silhouette IoU loss {losses[-1]:.4f}")
    return [float(x) for x in torch.stack(losses).cpu()], fvi.detach()


def main(device="cpu", res=64, iters=60, verbose=True):
    """Recover a triangle's x shift (0.45 → 0) from its silhouette.
    Returns (loss per step, recovered shift)."""
    losses, fvi = optimize(device, res, iters, verbose)
    shift = float(fvi[..., 0].mean())
    if verbose:
        print(f"final loss {losses[-1]:.4f}; recovered shift {shift:+.3f} "
              "(target 0)")
    return losses, shift


def uv_sphere(n_lat=40, n_lon=64):
    """Unit UV sphere → (vertices (V, 3) float32, faces (F, 3) int32)."""
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces.append([a, b, c])
            faces.append([b, d, c])
    return v.astype(np.float32), np.asarray(faces, np.int32)


def config2_inputs(n_lat=40, n_lon=64):
    """Config 2 as numpy arrays: the sphere at z = −3 projected to the
    image plane, random features from ``RandomState(0)``, every face valid.
    40 × 64 gives 4992 faces."""
    v, f = uv_sphere(n_lat, n_lon)
    num_faces = f.shape[0]
    cam = v + np.array([0, 0, -3.0], np.float32)
    z = cam[:, 2]
    img_xy = cam[:, :2] / (-z[:, None]) * 2.0
    return {
        "face_vertices_z": z[f][None],
        "face_vertices_image": img_xy[f][None],
        "face_features": np.random.RandomState(0).rand(
            1, num_faces, 3, 3).astype(np.float32),
        "face_normals_z": np.ones((1, num_faces), np.float32),
    }


def config2_loss(inputs, fvi, feats, res):
    img, soft, _ = dibr_rasterization(res, res, inputs["face_vertices_z"],
                                      fvi, feats, inputs["face_normals_z"])
    return torch.sum(img ** 2) + torch.sum(soft ** 2)


def config2_grad(inputs, fvi, feats, res, loss_fn=config2_loss):
    """One forward and backward → (loss, grad fvi, grad features)."""
    fvi = fvi.detach().requires_grad_(True)
    feats = feats.detach().requires_grad_(True)
    loss = loss_fn(inputs, fvi, feats, res)
    g_fvi, g_feat = torch.autograd.grad(loss, (fvi, feats))
    return loss.detach(), g_fvi, g_feat


def config2_step(device, res=512, steps=5, n_lat=40, n_lon=64):
    """``steps`` gradient-descent steps of config 2 with learning rate 1e-6
    → dict with the loss per step, the last gradients and the updated
    parameters."""
    inputs = from_numpy_tree(config2_inputs(n_lat, n_lon), device)
    fvi = inputs["face_vertices_image"]
    feats = inputs["face_features"]
    losses = []
    for _ in range(steps):
        loss, g_fvi, g_feat = config2_grad(inputs, fvi, feats, res)
        fvi = fvi - 1e-6 * g_fvi
        feats = feats - 1e-6 * g_feat
        losses.append(loss)
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "grad_fvi": g_fvi, "grad_feat": g_feat, "fvi": fvi,
            "feat": feats}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cpu")
