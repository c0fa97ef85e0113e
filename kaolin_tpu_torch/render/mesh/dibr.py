"""DIB-R soft silhouette and the full rasterization wrapper, in PyTorch.

Counterpart of ``kaolin_tpu/render/mesh/dibr.py``. Covered pixels get 1;
an uncovered pixel gets ``1 − ∏(1 − exp(−sigmainv·d²/mult²))`` over the
faces whose boxlen-enlarged bbox contains it, with d² the least squared
distance to the face's 3 edges (perpendicular where the foot lies on the
segment) and 3 vertices.

``knum_mode="all"`` (the default) lets every in-box face contribute: on a
CUDA tensor through the forward and backward kernels of
:mod:`.cuda_soft_mask` (:class:`_SoftMask`), on a CPU tensor through the
plain :func:`soft_mask_plain` and its autograd. ``knum_mode="first"``
reproduces the reference kernel's truncation to each pixel's first ``knum``
in-box faces and is plain PyTorch on every device, as it is plain XLA in
the JAX package.
"""

import torch
from torch.utils.checkpoint import checkpoint

from kaolin_tpu_torch.render.mesh import cuda_soft_mask
from kaolin_tpu_torch.render.mesh.rasterization import (
    CHUNK,
    _pixel_coords,
    rasterize,
)
from kaolin_tpu_torch.utils.backend import is_cuda

__all__ = ["dibr_soft_mask", "dibr_rasterization", "soft_mask_plain"]

_EPS = 1e-10


def _edge_vertex_sqdist(px, py, verts, multiplier):
    """Least squared distance from pixel to a triangle's edges and vertices
    in image space, broadcast over (..., T) faces. Tied minima share the
    gradient evenly (``torch.amin``)."""
    dists = []
    for i in range(3):
        x1 = verts[..., i, 0]
        y1 = verts[..., i, 1]
        x2 = verts[..., (i + 1) % 3, 0]
        y2 = verts[..., (i + 1) % 3, 1]
        A = y2 - y1
        B = x1 - x2
        C = x2 * y1 - x1 * y2
        up = A * px + B * py + C
        down = A * A + B * B
        x3 = (B * B * px - A * B * py - A * C) / (down + _EPS)
        y3 = (A * A * py - A * B * px - B * C) / (down + _EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up / (down + _EPS)
        bad = 4.0 * multiplier * multiplier
        dists.append(torch.where(direct > 0, bad, perp))
    for i in range(3):
        x1 = verts[..., i, 0]
        y1 = verts[..., i, 1]
        dists.append((px - x1) ** 2 + (py - y1) ** 2)
    return torch.amin(torch.stack(dists, dim=-1), dim=-1)


def _chunk_factor(px, py, verts, include, sigmainv, multiplier):
    """∏ (1 − p) over one chunk of faces → (B, H, W)."""
    d2 = _edge_vertex_sqdist(px, py, verts[:, None, None], multiplier)
    prob = torch.where(include,
                       torch.exp(-sigmainv * d2 / (multiplier * multiplier)),
                       0.0)
    return torch.prod(1.0 - prob, dim=-1)


def soft_mask_plain(face_vertices_image, sigmainv, boxlen, multiplier,
                    height, width, knum=None, face_idx=None):
    """All-faces allprob = ∏ (1 − p) → (B, H, W), ``CHUNK`` faces at a time.

    ``face_vertices_image`` is (B, F, 3, 2), already scaled by
    ``multiplier``. ``knum=None`` lets every in-box face contribute; an int
    keeps only each pixel's first ``knum`` in-box faces in face-index order.
    Each chunk runs under ``torch.utils.checkpoint``, so autograd keeps one
    (B, H, W) product per chunk, not its (B, H, W, chunk) intermediates.
    ``face_idx``, the rasterizer's (B, H, W) ids, sets allprob to 1 where an
    id is ≥ 0, as the kernel does. The plain version of the CUDA forward
    kernel; its autograd is the plain version of the backward kernel."""
    b, f = face_vertices_image.shape[:2]
    dtype = face_vertices_image.dtype
    device = face_vertices_image.device
    px, py = _pixel_coords(height, width, multiplier, dtype, device)
    px = px[..., None]
    py = py[..., None]
    margin = boxlen * multiplier
    allprob = torch.ones((b, height, width), dtype=dtype, device=device)
    count = torch.zeros((b, height, width), dtype=torch.int32, device=device)
    for s in range(0, f, CHUNK):
        verts = face_vertices_image[:, s:s + CHUNK]
        box = verts.detach()
        bmin = (box.amin(dim=2) - margin)[:, None, None]     # (B, 1, 1, T, 2)
        bmax = (box.amax(dim=2) + margin)[:, None, None]
        include = ((px >= bmin[..., 0]) & (px < bmax[..., 0])
                   & (py >= bmin[..., 1]) & (py < bmax[..., 1]))
        if knum is not None:
            in_box = include.to(torch.int32)
            include = include & (count[..., None] + in_box.cumsum(-1) <= knum)
            count = count + in_box.sum(-1, dtype=torch.int32)
        allprob = allprob * checkpoint(_chunk_factor, px, py, verts, include,
                                       sigmainv, multiplier,
                                       use_reentrant=False)
    if face_idx is not None:
        allprob = torch.where(face_idx >= 0, 1.0, allprob)
    return allprob


def _soft_mask_bwd_plain(face_vertices_image, grad_allprob, sigmainv, boxlen,
                         multiplier, height, width):
    """The vector-Jacobian product of :func:`soft_mask_plain`."""
    with torch.enable_grad():
        v = face_vertices_image.detach().requires_grad_(True)
        allprob = soft_mask_plain(v, sigmainv, boxlen, multiplier, height,
                                  width)
        (grad,) = torch.autograd.grad(allprob, v, grad_allprob)
    return grad


class _SoftMask(torch.autograd.Function):
    """allprob (B, H, W) of the scaled ``face_vertices_image``, every in-box
    face contributing. On CUDA, the forward and the backward are the two
    soft-mask kernels; on the CPU, their plain versions.

    ``face_idx`` (optional, not differentiable): the rasterizer's ids;
    allprob is 1 where an id is ≥ 0 and is not computed there. Only for a
    caller that discards allprob at those pixels, as dibr_soft_mask does:
    the gradient is that of allprob without ``face_idx``, and the cotangent
    it receives there is 0, so ``ga = 0`` there either way."""

    @staticmethod
    def forward(ctx, face_vertices_image, sigmainv, boxlen, multiplier,
                height, width, face_idx=None):
        args = (sigmainv, boxlen, multiplier, height, width)
        fvi = face_vertices_image.detach()
        if is_cuda(fvi):
            fvi = fvi.contiguous()
            if face_idx is not None:
                face_idx = face_idx.to(torch.int32).contiguous()
            allprob = cuda_soft_mask.soft_mask_fwd_cuda(fvi, *args,
                                                        face_idx=face_idx)
        else:
            allprob = soft_mask_plain(fvi, *args, face_idx=face_idx)
        ctx.save_for_backward(fvi, allprob)
        ctx.args = args
        return allprob

    @staticmethod
    def backward(ctx, grad_allprob):
        fvi, allprob = ctx.saved_tensors
        if is_cuda(fvi):
            ga = (grad_allprob * allprob).contiguous()
            grad = cuda_soft_mask.soft_mask_bwd_cuda(fvi, ga, *ctx.args)
        else:
            grad = _soft_mask_bwd_plain(fvi, grad_allprob, *ctx.args)
        return grad, None, None, None, None, None, None


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000.0, knum_mode="all"):
    """Soft foreground mask for silhouette losses → (B, H, W).
    Differentiable with respect to ``face_vertices_image`` (B, F, 3, 2).

    ``knum_mode``: "all" (default) lets every in-box face contribute;
    "first" keeps each pixel's first ``knum`` in-box faces in face-index
    order, as the reference CUDA kernel does."""
    height, width = selected_face_idx.shape[1:3]
    scaled = face_vertices_image * multiplier
    if knum_mode == "first":
        allprob = soft_mask_plain(scaled, sigmainv, boxlen, multiplier,
                                  height, width, knum=int(knum))
    elif knum_mode == "all":
        allprob = _SoftMask.apply(scaled, sigmainv, boxlen, multiplier,
                                  height, width, selected_face_idx)
    else:
        raise ValueError(f"unknown knum_mode {knum_mode!r}")
    return torch.where(selected_face_idx >= 0, 1.0, 1.0 - allprob)


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None):
    """Full DIB-R: rasterize features and the soft mask. A face is valid
    (not culled) where ``face_normals_z >= 0``, as in the JAX package's code.

    Returns (image_features, soft_mask (B, H, W), face_idx (B, H, W))."""
    valid_faces = face_normals_z >= 0.0
    image_features, face_idx = rasterize(
        height, width, face_vertices_z, face_vertices_image, face_features,
        valid_faces=valid_faces, multiplier=multiplier, eps=eps)
    if multiplier is None:
        multiplier = 1000.0
    soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                               boxlen, knum, multiplier)
    return image_features, soft_mask, face_idx
