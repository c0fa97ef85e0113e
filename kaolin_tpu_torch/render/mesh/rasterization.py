"""Differentiable mesh rasterization (DIB-R style), in PyTorch.

Counterpart of ``kaolin_tpu/render/mesh/rasterization.py``. Per-pixel
z-buffer with 2D cross-product barycentrics (signed-eps normalised), the
max-z (closest) winner, and linear feature interpolation.

The winner search runs without gradient: on a CUDA tensor it is the
hand-written kernel (:mod:`.cuda_rasterize`), on a CPU tensor its plain
version :func:`rasterize_search_plain`. Both visit every face whose box holds
the pixel, so both are exact at any face count and the port has no tile
capacities. The winners' barycentrics and features are then re-computed
from their vertices: on a CUDA tensor by the re-gather kernels
(:mod:`.cuda_regather`, through :class:`_Regather`), on a CPU tensor by
their plain version :func:`interpolate_at_winners_plain`, which autograd
differentiates.

Spans (:mod:`kaolin_tpu_torch.utils.profiling`, while the profiler runs):
``render.mesh.rasterize.search`` and ``render.mesh.rasterize.interpolate``
with its ``.backward``.
"""

import math

import torch
from torch.autograd.function import once_differentiable

from kaolin_tpu_torch.render.mesh import cuda_rasterize, cuda_regather
from kaolin_tpu_torch.utils import profiling
from kaolin_tpu_torch.utils.backend import is_cuda

__all__ = ["rasterize", "rasterize_search_plain", "tile_face_lists",
           "suggest_tile_cap", "tile_overflow_report"]

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


def chunk_window(verts, margin, height, width, multiplier, valid=None):
    """The rows and columns (two slices) holding every pixel centre that
    can lie in the box of one of ``verts``' faces (B, T, 3, 2), scaled by
    ``multiplier``, enlarged by ``margin`` and left out where ``valid``
    (B, T) is False; None where there is no such pixel. Conservative by a
    pixel on each side, so a plain version that tests its boxes exactly
    inside the window computes what it computes on the whole image."""
    lo = verts.detach().amin(dim=-2)
    hi = verts.detach().amax(dim=-2)
    if valid is not None:
        lo = torch.where(valid[..., None], lo, torch.inf)
        hi = torch.where(valid[..., None], hi, -torch.inf)
    (x0, y0), (x1, y1) = (lo.reshape(-1, 2).amin(dim=0).tolist(),
                          hi.reshape(-1, 2).amax(dim=0).tolist())
    if not all(map(math.isfinite, (x0, y0, x1, y1))):
        if x0 > x1 or y0 > y1:     # nothing valid
            return None
        return slice(0, height), slice(0, width)
    x0, x1 = x0 - margin, x1 + margin
    y0, y1 = y0 - margin, y1 + margin
    c0 = max(math.floor((x0 / multiplier * width + width - 1) / 2) - 1, 0)
    c1 = min(math.ceil((x1 / multiplier * width + width - 1) / 2) + 1,
             width - 1)
    r0 = max(math.floor((height - 1 - y1 / multiplier * height) / 2) - 1, 0)
    r1 = min(math.ceil((height - 1 - y0 / multiplier * height) / 2) + 1,
             height - 1)
    if c0 > c1 or r0 > r1:
        return None
    return slice(r0, r1 + 1), slice(c0, c1 + 1)


def rasterize_search_plain(face_vertices_z, face_vertices_image, valid_mask,
                           multiplier, eps, height, width):
    """Brute winner search over all faces, ``CHUNK`` faces at a time
    → (B, H, W) int32 face ids, −1 on a miss; ties go to the lowest id.

    ``face_vertices_image`` is (B, F, 3, 2), already scaled by
    ``multiplier``. A face is tested only at the pixels inside its closed
    bounding box, as in the reference CUDA rasterizer. A triangle lies in
    its box, so this drops only hits that rounding makes: those of a
    zero-area face, whose barycentrics can all be 0 along its line or across
    the whole image (the JAX package's brute search keeps them). Each chunk
    is computed on the window of pixels its valid boxes can hold
    (:func:`chunk_window`). The plain version of the CUDA winner kernel."""
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
        window = chunk_window(face_vertices_image[:, s:s + CHUNK], 0.0,
                              height, width, multiplier,
                              valid_mask[:, s:s + CHUNK])
        if window is None:
            continue
        rows, cols = window
        wx, wy = px[rows, cols], py[rows, cols]
        verts = face_vertices_image[:, None, None, s:s + CHUNK]
        zs = face_vertices_z[:, None, None, s:s + CHUNK]
        lo = verts.amin(dim=-2)                              # (B, 1, 1, T, 2)
        hi = verts.amax(dim=-2)
        in_box = ((wx >= lo[..., 0]) & (wx <= hi[..., 0])
                  & (wy >= lo[..., 1]) & (wy <= hi[..., 1]))
        w0, w1, w2 = _barycentrics(wx, wy, verts, eps)       # (B, h, w, T)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & in_box
        z = w0 * zs[..., 0] + w1 * zs[..., 1] + w2 * zs[..., 2]
        z = torch.where(inside & valid_mask[:, None, None, s:s + CHUNK], z,
                        -torch.inf)
        tmax = z.amax(dim=-1)
        targ = z.argmax(dim=-1).to(torch.int32) + s   # first maximum
        take = tmax > best_z[:, rows, cols]
        best_z[:, rows, cols] = torch.where(take, tmax, best_z[:, rows, cols])
        best_i[:, rows, cols] = torch.where(take, targ, best_i[:, rows, cols])
    return torch.where(torch.isfinite(best_z), best_i, -1)


def tile_face_lists(face_vertices_image, height, width, multiplier,
                    margin=0.0, valid_mask=None):
    """The mesh kernels' tile cull (``csrc/tiles.cuh``) in plain PyTorch →
    per batch element, per ``TILE`` x ``TILE`` tile (row-major), the int64
    ids of the faces the kernel's block lists, in the order it lists them.

    ``face_vertices_image`` is (B, F, 3, 2), already scaled by
    ``multiplier``. A face is listed where its closed box, enlarged by
    ``margin`` (0 for the winner search, ``boxlen * multiplier`` for the
    soft mask) and empty where ``valid_mask`` is False, meets the tile's
    pixel-centre rectangle; the block reaches it through the box of its
    group of ``GROUP`` consecutive faces. Rounded as the kernels round."""
    group, tile = cuda_rasterize.GROUP, cuda_rasterize.TILE
    b, f = face_vertices_image.shape[:2]
    v = face_vertices_image.detach()
    px, py = _pixel_coords(height, width, multiplier, v.dtype, v.device)
    xs, ys = px[0], py[:, 0]
    lo = v.amin(dim=2) - margin                                 # (B, F, 2)
    hi = v.amax(dim=2) + margin
    if valid_mask is not None:
        lo = torch.where(valid_mask[..., None], lo, torch.inf)
        hi = torch.where(valid_mask[..., None], hi, -torch.inf)
    n_groups = -(-f // group)
    pad = n_groups * group - f
    g_lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=torch.inf)
    g_hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-torch.inf)
    g_lo = g_lo.reshape(b, n_groups, group, 2).amin(dim=2)
    g_hi = g_hi.reshape(b, n_groups, group, 2).amax(dim=2)
    c0 = torch.arange(0, width, tile, device=v.device)
    r0 = torch.arange(0, height, tile, device=v.device)
    c1 = torch.clamp(c0 + tile, max=width) - 1
    r1 = torch.clamp(r0 + tile, max=height) - 1
    # per tile (row-major): x lo, x hi, y lo, y hi of its pixel centres
    rect = torch.stack([xs[c0][None].expand(len(r0), -1),
                        xs[c1][None].expand(len(r0), -1),
                        ys[r1][:, None].expand(-1, len(c0)),
                        ys[r0][:, None].expand(-1, len(c0))],
                       -1).reshape(-1, 4)

    def meet(lo, hi):   # (B, N, 2) boxes against every tile → (B, T, N)
        return ((lo[:, None, :, 0] <= rect[None, :, None, 1])
                & (hi[:, None, :, 0] >= rect[None, :, None, 0])
                & (lo[:, None, :, 1] <= rect[None, :, None, 3])
                & (hi[:, None, :, 1] >= rect[None, :, None, 2]))

    faces, groups = meet(lo, hi), meet(g_lo, g_hi)
    lanes = torch.arange(group, device=v.device)
    lists = []
    for i in range(b):
        per_tile = []
        for t in range(rect.shape[0]):
            ids = (torch.nonzero(groups[i, t])[:, 0, None] * group
                   + lanes).reshape(-1)
            ids = ids[ids < f]
            per_tile.append(ids[faces[i, t, ids]])
        lists.append(per_tile)
    return lists


def tile_rects(height, width, tile_px, multiplier, device):
    """The JAX package's per-tile pixel-centre extents in kernel coords
    → (x_lo, x_hi) (W/tile_px,) and (y_lo, y_hi) (H/tile_px,)."""
    i0 = torch.arange(width // tile_px, device=device) * tile_px
    r0 = torch.arange(height // tile_px, device=device) * tile_px
    i1 = i0 + tile_px - 1
    r1 = r0 + tile_px - 1
    x_lo = multiplier / width * (2 * i0 + 1 - width)
    x_hi = multiplier / width * (2 * i1 + 1 - width)
    y_hi = multiplier / height * (height - 2 * r0 - 1)
    y_lo = multiplier / height * (height - 2 * r1 - 1)
    return x_lo, x_hi, y_lo, y_hi


def _tile_overlap(face_vertices_image, valid_mask, height, width, multiplier,
                  tile_px, margin=0.0):
    """The JAX binned backends' (num_tiles, F) bool: a face's bbox, enlarged
    by ``margin``, meets a tile's closed pixel-centre rectangle."""
    f = face_vertices_image.shape[0]
    fmin = face_vertices_image.amin(dim=1) - margin     # (F, 2)
    fmax = face_vertices_image.amax(dim=1) + margin
    x_lo, x_hi, y_lo, y_hi = tile_rects(height, width, tile_px, multiplier,
                                        face_vertices_image.device)
    ox = (fmin[None, :, 0] <= x_hi[:, None]) \
        & (fmax[None, :, 0] >= x_lo[:, None])
    oy = (fmin[None, :, 1] <= y_hi[:, None]) \
        & (fmax[None, :, 1] >= y_lo[:, None])
    overlap = (oy[:, None, :] & ox[None, :, :]) & valid_mask[None, None]
    return overlap.reshape(-1, f)


def tile_overflow_report(face_vertices_image, height, width,
                         valid_faces=None, multiplier=None, tile_px=32,
                         tile_cap=512, margin_boxlen=0.0):
    """What the JAX package's capacity-binned backends would drop at
    ``tile_px`` and ``tile_cap``, from their binning arithmetic → a dict of
    (B,) tensors: ``any_overflow`` (bool), ``num_overflowing_tiles`` and
    ``max_overlap`` (int; a cap of at least this is exact there).

    The port has no capacities: its searches visit every face, so nothing
    in its path depends on this report."""
    if multiplier is None:
        multiplier = DEFAULT_MULTIPLIER
    fvi = face_vertices_image
    if fvi.dim() == 3:
        fvi = fvi[None]
    b, f = fvi.shape[:2]
    if valid_faces is None:
        valid_faces = torch.ones((b, f), dtype=torch.bool, device=fvi.device)
    scaled = (fvi * multiplier).detach()
    margin = margin_boxlen * multiplier
    counts = torch.stack([
        _tile_overlap(v, m.bool(), height, width, multiplier, tile_px,
                      margin).sum(dim=1, dtype=torch.int32)
        for v, m in zip(scaled, valid_faces)])
    overflow = counts > tile_cap
    return {"any_overflow": overflow.any(dim=1),
            "num_overflowing_tiles": overflow.sum(dim=1, dtype=torch.int32),
            "max_overlap": counts.amax(dim=1)}


def suggest_tile_cap(face_vertices_image, height, width, multiplier=None,
                     tile_px=32, boxlen=0.02, headroom=1.25):
    """The per-tile face capacity the JAX package's binned backends need:
    the most faces whose ``boxlen``-enlarged bbox meets one tile, over every
    face of ``face_vertices_image`` (any batch shape) taken as one set,
    times ``headroom``, rounded up to a multiple of 64, and held in [64, F]
    → int. The port takes no capacity; this is the JAX package's API."""
    if multiplier is None:
        multiplier = DEFAULT_MULTIPLIER
    fvi = face_vertices_image.detach().reshape(-1, 3, 2)
    f = fvi.shape[0]
    overlap = _tile_overlap(fvi * multiplier,
                            torch.ones(f, dtype=torch.bool,
                                       device=fvi.device),
                            height, width, multiplier, tile_px,
                            boxlen * multiplier)
    max_overlap = int(overlap.sum(dim=1).max())
    cap = int(math.ceil(max_overlap * headroom / 64.0)) * 64
    return max(64, min(f, cap))


def _rasterize_search(face_vertices_z, face_vertices_image, valid_mask,
                      multiplier, eps, height, width):
    if is_cuda(face_vertices_z):
        return cuda_rasterize.rasterize_search_cuda(
            face_vertices_z.contiguous(), face_vertices_image.contiguous(),
            valid_mask.contiguous(), multiplier, eps, height, width)
    return rasterize_search_plain(face_vertices_z, face_vertices_image,
                                  valid_mask, multiplier, eps, height, width)


def interpolate_at_winners_plain(face_idx, scaled, features, multiplier,
                                 eps):
    """Differentiable re-computation at the winners: one gather of the
    winners' scaled vertices and features from a (B, F, 6 + 3D) table, then
    barycentric interpolation → (B, H, W, D), 0 on a miss. The plain version
    of the re-gather kernels (:mod:`.cuda_regather`)."""
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


class _Regather(torch.autograd.Function):
    """The winners' interpolated features (B, H, W, D) on the card: the
    forward and backward kernels of :mod:`.cuda_regather`. The backward
    gives the features' gradient only where it is asked for; its gradients
    are not differentiable: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, face_idx, scaled, features, multiplier, eps):
        ctx.save_for_backward(face_idx, scaled, features)
        ctx.multiplier, ctx.eps = multiplier, eps
        return cuda_regather.regather_fwd_cuda(face_idx, scaled, features,
                                               multiplier, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        face_idx, scaled, features = ctx.saved_tensors
        grad_scaled, grad_features = cuda_regather.regather_bwd_cuda(
            face_idx, scaled, features, grad_out.contiguous(),
            ctx.multiplier, ctx.eps, *ctx.needs_input_grad[1:3])
        return None, grad_scaled, grad_features, None, None


def _interpolate_at_winners(face_idx, scaled, features, multiplier, eps):
    """The winners' barycentric interpolation of ``features`` (B, F, 3, D)
    at ``face_idx`` (B, H, W) from the ``scaled`` vertices (B, F, 3, 2) →
    (B, H, W, D), 0 on a miss: the re-gather kernels for CUDA tensors
    (a batch of features expanded from one is read as it is), the plain
    version for CPU tensors."""
    if is_cuda(scaled):
        if features.shape[0] > 0 and not features[0].is_contiguous():
            features = features.contiguous()
        return _Regather.apply(face_idx.contiguous(), scaled.contiguous(),
                               features, multiplier, eps)
    return interpolate_at_winners_plain(face_idx, scaled, features,
                                        multiplier, eps)


BACKENDS = ("brute", "binned")
IMPLS = ("pallas", "xla")


def check_name(name, value, choices):
    """Refuse a value of a JAX option that is neither None nor a name the
    JAX package documents for it."""
    if value is not None and value not in choices:
        raise ValueError(f"unknown {name} {value!r}; expected None or one of "
                         f"{choices}")


def check_options(height, width, backend=None, tile_px=None, impl=None):
    """Check the JAX package's rasterizer options as it does → tile_px.

    ``backend`` is None or one of ``BACKENDS``, ``impl`` None or one of
    ``IMPLS``. ``tile_px`` defaults to 16 for "pallas" and 32 otherwise (an
    ``impl`` of None is "xla" off a TPU); "binned" needs it to divide the
    image. The values choose among the JAX package's searches, which all
    give one result; the port has one search per device and no capacities,
    so beyond these checks they have no effect here."""
    check_name("backend", backend, BACKENDS)
    check_name("impl", impl, IMPLS)
    if tile_px is None:
        tile_px = 16 if impl == "pallas" else 32
    if backend == "binned" and (height % tile_px or width % tile_px):
        raise ValueError(
            f"backend='binned' needs height/width divisible by tile_px="
            f"{tile_px}, got {height}x{width}")
    return tile_px


def rasterize(height, width, face_vertices_z, face_vertices_image,
              face_features, valid_faces=None, multiplier=None, eps=None,
              backend=None, tile_px=None, tile_cap=None, impl=None):
    """Differentiable rasterization to feature images.

    Args:
        height, width: ints; any size.
        face_vertices_z: (B, F, 3) camera-space z per face vertex.
        face_vertices_image: (B, F, 3, 2) image-plane coords in [-1, 1].
        face_features: (B, F, 3, D) or a list of such.
        valid_faces: optional (B, F) bool.
        multiplier: coordinate scale for numerics (default 1000).
        eps: barycentric normalisation epsilon (default 1e-8).
        backend, tile_px, tile_cap, impl: the JAX package's choice of
            search and its per-tile face capacity, in its positions and
            checked as it checks them (:func:`check_options`). They have no
            effect in the port: every device runs one exact search with no
            capacity, so no face is ever dropped.

    Returns:
        (image_features (B, H, W, D) [or a list], face_idx (B, H, W) int32,
        −1 for background). Differentiable with respect to
        ``face_vertices_image`` and ``face_features``.
    """
    check_options(height, width, backend, tile_px, impl)
    if multiplier is None:
        multiplier = DEFAULT_MULTIPLIER
    if eps is None:
        eps = DEFAULT_EPS
    is_list = isinstance(face_features, (list, tuple))
    feats = list(face_features) if is_list else [face_features]
    feat_dims = [x.shape[-1] for x in feats]
    features = feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)

    b, f = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_mask = torch.ones((b, f), dtype=torch.bool,
                                device=face_vertices_z.device)
    else:
        valid_mask = valid_faces.bool()

    scaled = face_vertices_image * multiplier
    with torch.no_grad(), profiling.span("render.mesh.rasterize.search"):
        face_idx = _rasterize_search(face_vertices_z.detach(),
                                     scaled.detach(), valid_mask, multiplier,
                                     eps, height, width)
    with profiling.span("render.mesh.rasterize.interpolate"):
        interp = _interpolate_at_winners(face_idx, scaled, features,
                                         multiplier, eps)
        profiling.backward_span("render.mesh.rasterize.interpolate",
                                (scaled, features), interp)
    if is_list:
        return list(torch.split(interp, feat_dims, dim=-1)), face_idx
    return interp, face_idx
