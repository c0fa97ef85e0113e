"""Differentiable mesh rasterization (DIB-R style), in PyTorch.

Counterpart of ``kaolin_tpu/render/mesh/rasterization.py``. Per-pixel
z-buffer with 2D cross-product barycentrics (signed-eps normalised), the
max-z (closest) winner, and linear feature interpolation.

The winner search runs without gradient: on a CUDA tensor it is the
hand-written kernel (:mod:`.cuda_rasterize`), on a CPU tensor its plain
version :func:`rasterize_search_plain`. Both visit every face whose box holds
the pixel, so both are exact at any face count and the port has no tile
capacities. The winners' barycentrics and features are then re-computed
from gathered vertices in plain PyTorch, and autograd gives the backward.
"""

import torch

from kaolin_tpu_torch.render.mesh import cuda_rasterize
from kaolin_tpu_torch.utils.backend import is_cuda

__all__ = ["rasterize", "rasterize_search_plain"]

DEFAULT_MULTIPLIER = 1000
DEFAULT_EPS = 1e-8
# Faces per step of the plain versions: bounds their (B, H, W, CHUNK)
# intermediates, as the JAX package's face-tile scans do.
CHUNK = 128


def _pixel_coords(height, width, multiplier, dtype, device):
    """Pixel-centre coords, x right and y up → (px, py), each (H, W)."""
    wid = torch.arange(width, dtype=dtype, device=device)
    hei = torch.arange(height, dtype=dtype, device=device)
    x0 = multiplier / width * (2 * wid + 1 - width)
    y0 = multiplier / height * (height - 2 * hei - 1)
    return torch.meshgrid(x0, y0, indexing="xy")


def _barycentrics(px, py, verts, eps):
    """verts (..., 3, 2) broadcast against px/py (...,)."""
    ax = verts[..., 0, 0] - px
    ay = verts[..., 0, 1] - py
    bx = verts[..., 1, 0] - px
    by = verts[..., 1, 1] - py
    cx = verts[..., 2, 0] - px
    cy = verts[..., 2, 1] - py
    w0 = bx * cy - by * cx
    w1 = cx * ay - cy * ax
    w2 = ax * by - ay * bx
    norm = w0 + w1 + w2
    norm = norm + torch.where(norm >= 0, eps, -eps)
    return w0 / norm, w1 / norm, w2 / norm


def rasterize_search_plain(face_vertices_z, face_vertices_image, valid_mask,
                           multiplier, eps, height, width):
    """Brute winner search over all faces, ``CHUNK`` faces at a time
    → (B, H, W) int32 face ids, −1 on a miss; ties go to the lowest id.

    ``face_vertices_image`` is (B, F, 3, 2), already scaled by
    ``multiplier``. A face is tested only at the pixels inside its closed
    bounding box, as in the reference CUDA rasterizer. A triangle lies in
    its box, so this drops only hits that rounding makes: those of a
    zero-area face, whose barycentrics can all be 0 along its line or across
    the whole image (the JAX package's brute search keeps them). The plain
    version of the CUDA winner kernel."""
    b, f = face_vertices_z.shape[:2]
    dtype = face_vertices_z.dtype
    device = face_vertices_z.device
    px, py = _pixel_coords(height, width, multiplier, dtype, device)
    px = px[..., None]
    py = py[..., None]
    best_z = torch.full((b, height, width), -torch.inf, dtype=dtype,
                        device=device)
    best_i = torch.full((b, height, width), -1, dtype=torch.int32,
                        device=device)
    for s in range(0, f, CHUNK):
        verts = face_vertices_image[:, None, None, s:s + CHUNK]
        zs = face_vertices_z[:, None, None, s:s + CHUNK]
        lo = verts.amin(dim=-2)                              # (B, 1, 1, T, 2)
        hi = verts.amax(dim=-2)
        in_box = ((px >= lo[..., 0]) & (px <= hi[..., 0])
                  & (py >= lo[..., 1]) & (py <= hi[..., 1]))
        w0, w1, w2 = _barycentrics(px, py, verts, eps)       # (B, H, W, T)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & in_box
        z = w0 * zs[..., 0] + w1 * zs[..., 1] + w2 * zs[..., 2]
        z = torch.where(inside & valid_mask[:, None, None, s:s + CHUNK], z,
                        -torch.inf)
        tmax = z.amax(dim=-1)
        targ = z.argmax(dim=-1).to(torch.int32) + s   # first maximum
        take = tmax > best_z
        best_z = torch.where(take, tmax, best_z)
        best_i = torch.where(take, targ, best_i)
    return torch.where(torch.isfinite(best_z), best_i, -1)


def _rasterize_search(face_vertices_z, face_vertices_image, valid_mask,
                      multiplier, eps, height, width):
    if is_cuda(face_vertices_z):
        return cuda_rasterize.rasterize_search_cuda(
            face_vertices_z.contiguous(), face_vertices_image.contiguous(),
            valid_mask.contiguous(), multiplier, eps, height, width)
    return rasterize_search_plain(face_vertices_z, face_vertices_image,
                                  valid_mask, multiplier, eps, height, width)


def _interpolate_at_winners(face_idx, scaled, features, multiplier, eps):
    """Differentiable re-computation at the winners: one gather of the
    winners' scaled vertices and features from a (B, F, 6 + 3D) table, then
    barycentric interpolation → (B, H, W, D), 0 on a miss."""
    b, height, width = face_idx.shape
    f = scaled.shape[1]
    d = features.shape[-1]
    table = torch.cat([scaled.reshape(b, f, 6),
                       features.reshape(b, f, 3 * d)], dim=-1)
    safe_idx = face_idx.clamp(min=0).long().reshape(b, -1, 1)
    sel = torch.gather(table, 1, safe_idx.expand(-1, -1, table.shape[-1]))
    sel_v = sel[..., :6].reshape(b, height, width, 3, 2)
    sel_feat = sel[..., 6:].reshape(b, height, width, 3, d)

    px, py = _pixel_coords(height, width, multiplier, scaled.dtype,
                           scaled.device)
    w0, w1, w2 = _barycentrics(px[None], py[None], sel_v, eps)
    hit = (face_idx >= 0)[..., None]
    interp = (w0[..., None] * sel_feat[..., 0, :]
              + w1[..., None] * sel_feat[..., 1, :]
              + w2[..., None] * sel_feat[..., 2, :])
    return torch.where(hit, interp, 0.0)


def rasterize(height, width, face_vertices_z, face_vertices_image,
              face_features, valid_faces=None, multiplier=None, eps=None):
    """Differentiable rasterization to feature images.

    Args:
        height, width: ints; any size.
        face_vertices_z: (B, F, 3) camera-space z per face vertex.
        face_vertices_image: (B, F, 3, 2) image-plane coords in [-1, 1].
        face_features: (B, F, 3, D) or a list of such.
        valid_faces: optional (B, F) bool.
        multiplier: coordinate scale for numerics (default 1000).
        eps: barycentric normalisation epsilon (default 1e-8).

    Returns:
        (image_features (B, H, W, D) [or a list], face_idx (B, H, W) int32,
        −1 for background). Differentiable with respect to
        ``face_vertices_image`` and ``face_features``.
    """
    if multiplier is None:
        multiplier = DEFAULT_MULTIPLIER
    if eps is None:
        eps = DEFAULT_EPS
    is_list = isinstance(face_features, (list, tuple))
    feats = list(face_features) if is_list else [face_features]
    feat_dims = [x.shape[-1] for x in feats]
    features = torch.cat(feats, dim=-1)

    b, f = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_mask = torch.ones((b, f), dtype=torch.bool,
                                device=face_vertices_z.device)
    else:
        valid_mask = valid_faces.bool()

    scaled = face_vertices_image * multiplier
    with torch.no_grad():
        face_idx = _rasterize_search(face_vertices_z.detach(),
                                     scaled.detach(), valid_mask, multiplier,
                                     eps, height, width)
    interp = _interpolate_at_winners(face_idx, scaled, features, multiplier,
                                     eps)
    if is_list:
        return list(torch.split(interp, feat_dims, dim=-1)), face_idx
    return interp, face_idx
