"""DIB-R soft silhouette and the full rasterization wrapper, in PyTorch.

Counterpart of ``kaolin_tpu/render/mesh/dibr.py``. Covered pixels get 1;
an uncovered pixel gets ``1 − ∏(1 − exp(−sigmainv·d²/mult²))`` over the
faces whose boxlen-enlarged bbox contains it, with d² the least squared
distance to the face's 3 edges (perpendicular where the foot lies on the
segment) and 3 vertices.

``knum_mode="all"`` (the default) lets every in-box face contribute: on a
CUDA tensor through the forward and backward kernels of
:mod:`.cuda_soft_mask` (:class:`_SoftMask`), on a CPU tensor through their
plain versions :func:`soft_mask_plain` and :func:`_soft_mask_bwd_plain`,
which follow one rule for the gradient. ``knum_mode="first"``
reproduces the reference kernel's truncation to each pixel's first ``knum``
in-box faces and is plain PyTorch on every device, as it is plain XLA in
the JAX package.

Spans (:mod:`kaolin_tpu_torch.utils.profiling`, while the profiler runs):
``render.mesh.dibr_rasterization`` around the whole wrapper, and
``render.mesh.dibr_soft_mask`` with its ``.backward``, which is
:class:`_SoftMask`'s backward.
"""

import torch
from torch.utils.checkpoint import checkpoint

from kaolin_tpu_torch.render.mesh import cuda_soft_mask
from kaolin_tpu_torch.render.mesh.rasterization import (
    BACKENDS,
    CHUNK,
    IMPLS,
    _pixel_coords,
    check_name,
    check_options,
    chunk_window,
    rasterize,
)
from kaolin_tpu_torch.utils import profiling
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


def _chunk_terms(px, py, verts, include, sigmainv, multiplier):
    """d² and p = exp(−k·d²) of one chunk of faces → (B, H, W, T) each, p
    0 outside ``include``; k = sigmainv / multiplier²."""
    d2 = _edge_vertex_sqdist(px, py, verts[:, None, None], multiplier)
    prob = torch.where(include,
                       torch.exp(-sigmainv * d2 / (multiplier * multiplier)),
                       0.0)
    return d2, prob


def _chunk_factor(px, py, verts, include, sigmainv, multiplier):
    """∏ (1 − p) over one chunk of faces → (B, H, W)."""
    prob = _chunk_terms(px, py, verts, include, sigmainv, multiplier)[1]
    return torch.prod(1.0 - prob, dim=-1)


def _chunk_boxes(px, py, face_vertices_image, s, margin, multiplier,
                 need=None):
    """One chunk of faces and its half-open enlarged-box test on the pixels
    its boxes can hold (``chunk_window``) → (verts (B, T, 3, 2), include,
    where, px, py), or None where no such pixel is left.

    Without ``need``, ``where`` is the window (rows, cols), px and py are
    (h, w, 1) and include (B, h, w, T). With ``need`` (H, W) bool, only the
    window's pixels where it holds are taken: ``where`` is their (n,) flat
    indices, px and py are (n, 1, 1) and include (B, n, 1, T)."""
    verts = face_vertices_image[:, s:s + CHUNK]
    height, width = px.shape[:2]
    window = chunk_window(verts, margin, height, width, multiplier)
    if window is None:
        return None
    if need is None:
        where = window
        wx, wy = px[window], py[window]
    else:
        rows, cols = window
        r, c = torch.nonzero(need[window], as_tuple=True)
        if r.numel() == 0:
            return None
        where = (r + rows.start) * width + (c + cols.start)
        wx = px.reshape(-1)[where][:, None, None]
        wy = py.reshape(-1)[where][:, None, None]
    box = verts.detach()
    bmin = (box.amin(dim=2) - margin)[:, None, None]     # (B, 1, 1, T, 2)
    bmax = (box.amax(dim=2) + margin)[:, None, None]
    include = ((wx >= bmin[..., 0]) & (wx < bmax[..., 0])
               & (wy >= bmin[..., 1]) & (wy < bmax[..., 1]))
    return verts, include, where, wx, wy


def soft_mask_plain(face_vertices_image, sigmainv, boxlen, multiplier,
                    height, width, knum=None, face_idx=None):
    """All-faces allprob = ∏ (1 − p) → (B, H, W), ``CHUNK`` faces at a time.

    ``face_vertices_image`` is (B, F, 3, 2), already scaled by
    ``multiplier``. ``knum=None`` lets every in-box face contribute; an int
    keeps only each pixel's first ``knum`` in-box faces in face-index order.
    Each chunk is computed on the window of pixels its enlarged boxes can
    hold (``rasterization.chunk_window``; a factor of 1 elsewhere), with
    ``face_idx`` and ``knum=None`` only at the window's pixels that some
    batch element leaves uncovered, and runs under
    ``torch.utils.checkpoint``, so autograd keeps one (B, H, W) product per
    chunk, not its (B, h, w, chunk) intermediates.
    ``face_idx``, the rasterizer's (B, H, W) ids, sets allprob to 1 where an
    id is ≥ 0, as the kernel does. The plain version of the CUDA forward
    kernel.

    Its own autograd (``knum_mode="first"`` uses it) differentiates
    ``torch.prod``. The all-faces path (:class:`_SoftMask`) instead takes
    the backward kernel's rule on every device, whose plain version is
    :func:`_soft_mask_bwd_plain`: the cotangent into each in-box face's d²
    is ``ga·k·p / (1 − p)`` with ``ga = grad·allprob``, so where a factor
    1 − p rounds to 0, allprob is 0 and every face there gets 0 (JAX's
    Pallas and binned VJPs do the same). Autograd through the product
    would give that face ∏_{j≠i}(1 − p_j)·∂p_i instead."""
    b, f = face_vertices_image.shape[:2]
    dtype = face_vertices_image.dtype
    device = face_vertices_image.device
    px, py = _pixel_coords(height, width, multiplier, dtype, device)
    px = px[..., None]
    py = py[..., None]
    margin = boxlen * multiplier
    allprob = torch.ones((b, height, width), dtype=dtype, device=device)
    count = torch.zeros((b, height, width), dtype=torch.int32, device=device)
    # with the ids, only pixels some batch element leaves uncovered count
    need = None if face_idx is None or knum is not None \
        else (face_idx < 0).any(dim=0)
    for s in range(0, f, CHUNK):
        chunk = _chunk_boxes(px, py, face_vertices_image, s, margin,
                             multiplier, need)
        if chunk is None:      # a factor of 1 at every pixel
            continue
        verts, include, where, wx, wy = chunk
        if knum is not None:
            in_box = include.to(torch.int32)
            seen = count[(slice(None),) + where]
            include = include & (seen[..., None] + in_box.cumsum(-1) <= knum)
            count[(slice(None),) + where] = seen + in_box.sum(
                -1, dtype=torch.int32)
        factor = checkpoint(_chunk_factor, wx, wy, verts, include, sigmainv,
                            multiplier, use_reentrant=False)
        if need is None:
            rows, cols = where
            allprob = allprob * torch.nn.functional.pad(
                factor, (cols.start, width - cols.stop, rows.start,
                         height - rows.stop), value=1.0)
        else:
            flat = allprob.reshape(b, -1)
            allprob = flat.index_copy(
                1, where, flat[:, where] * factor.reshape(b, -1)).reshape(
                b, height, width)
    if face_idx is not None:
        allprob = torch.where(face_idx >= 0, 1.0, allprob)
    return allprob


def _soft_mask_bwd_plain(face_vertices_image, ga, sigmainv, boxlen,
                         multiplier, height, width):
    """The backward kernel's VJP of the all-faces allprob, in plain PyTorch:
    the gradient with respect to ``face_vertices_image`` (B, F, 3, 2) given
    ``ga = grad_allprob · allprob`` (B, H, W), as
    :func:`~kaolin_tpu_torch.render.mesh.cuda_soft_mask.soft_mask_bwd_cuda`
    takes it.

    Each in-box face's d² gets the cotangent ``ga · k·p / max(1 − p,
    1e-12)`` (∂allprob/∂d² = allprob · k·p / (1 − p)), pushed through d²
    by autograd, tied candidates sharing it evenly. Where a factor 1 − p
    rounds to 0, allprob and so ``ga`` are 0, and every face there gets 0:
    the rule of the CUDA backward and of JAX's Pallas and binned VJPs. Only
    the pixels where ``ga`` is not 0 are visited."""
    b, f = face_vertices_image.shape[:2]
    dtype = face_vertices_image.dtype
    device = face_vertices_image.device
    px, py = _pixel_coords(height, width, multiplier, dtype, device)
    px = px[..., None]
    py = py[..., None]
    k = sigmainv / (multiplier * multiplier)
    grads = []
    need = (ga != 0).any(dim=0)     # pixels with a cotangent
    ga = ga.reshape(b, -1)
    with torch.enable_grad():
        for s in range(0, f, CHUNK):
            chunk = _chunk_boxes(px, py, face_vertices_image.detach(), s,
                                 boxlen * multiplier, multiplier, need)
            if chunk is None:
                grads.append(torch.zeros_like(
                    face_vertices_image[:, s:s + CHUNK]))
                continue
            verts, include, where, wx, wy = chunk
            verts.requires_grad_(True)
            d2, prob = _chunk_terms(wx, wy, verts, include, sigmainv,
                                    multiplier)
            prob = prob.detach()
            c = ga[:, where][:, :, None, None] \
                / torch.clamp(1.0 - prob, min=1e-12) * k * prob
            c = torch.where(include, c, 0.0)
            grads.append(torch.autograd.grad(d2, verts, c)[0])
    return torch.cat(grads, dim=1)


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
        ctx.span = profiling.current()
        return allprob

    @staticmethod
    def backward(ctx, grad_allprob):
        with profiling.span("render.mesh.dibr_soft_mask.backward",
                            ctx.span):
            fvi, allprob = ctx.saved_tensors
            ga = (grad_allprob * allprob).contiguous()
            if is_cuda(fvi):
                grad = cuda_soft_mask.soft_mask_bwd_cuda(fvi, ga, *ctx.args)
            else:
                grad = _soft_mask_bwd_plain(fvi, ga, *ctx.args)
        return grad, None, None, None, None, None, None


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000.0, tile_px=None,
                   tile_cap=None, impl=None, knum_mode="all"):
    """Soft foreground mask for silhouette losses → (B, H, W).
    Differentiable with respect to ``face_vertices_image`` (B, F, 3, 2).

    ``tile_px``, ``tile_cap`` and ``impl`` are the JAX package's, in its
    positions; ``impl`` is checked as there (None, "pallas" or "xla"). They
    have no effect in the port: every in-box face contributes, with no
    per-tile capacity.

    ``knum_mode``: "all" (default) lets every in-box face contribute;
    "first" keeps each pixel's first ``knum`` in-box faces in face-index
    order, as the reference CUDA kernel does."""
    height, width = selected_face_idx.shape[1:3]
    if knum_mode not in ("all", "first"):
        raise ValueError(f"unknown knum_mode {knum_mode!r}")
    check_options(height, width, tile_px=tile_px, impl=impl)
    with profiling.span("render.mesh.dibr_soft_mask"):
        scaled = face_vertices_image * multiplier
        if knum_mode == "first":
            allprob = soft_mask_plain(scaled, sigmainv, boxlen, multiplier,
                                      height, width, knum=int(knum))
        else:
            allprob = _SoftMask.apply(scaled, sigmainv, boxlen, multiplier,
                                      height, width, selected_face_idx)
        return torch.where(selected_face_idx >= 0, 1.0, 1.0 - allprob)


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None,
                       rast_backend=None, tile_px=None, tile_cap=None):
    """Full DIB-R: rasterize features and the soft mask. A face is valid
    (not culled) where ``face_normals_z >= 0``, as in the JAX package's code.

    ``rast_backend``, ``tile_px`` and ``tile_cap`` are the JAX package's, in
    its positions. As there, ``tile_px`` and ``tile_cap`` go to both
    :func:`rasterize` and :func:`dibr_soft_mask`, which check them, and
    ``rast_backend`` is taken and not used. Its name is checked against the
    names the JAX rasterizer's options take, its ``backend``'s and its
    ``impl``'s: the JAX package's own calls pass either (its golden corpus
    passes "xla"). None of them has an effect in the port.

    Returns (image_features, soft_mask (B, H, W), face_idx (B, H, W))."""
    with profiling.span("render.mesh.dibr_rasterization"):
        check_name("rast_backend", rast_backend, BACKENDS + IMPLS)
        valid_faces = face_normals_z >= 0.0
        image_features, face_idx = rasterize(
            height, width, face_vertices_z, face_vertices_image,
            face_features, valid_faces=valid_faces, multiplier=multiplier,
            eps=eps, tile_px=tile_px, tile_cap=tile_cap)
        if multiplier is None:
            multiplier = 1000.0
        soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                                   boxlen, knum, multiplier, tile_px=tile_px,
                                   tile_cap=tile_cap)
    return image_features, soft_mask, face_idx
