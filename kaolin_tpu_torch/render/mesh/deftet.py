"""DefTet sparse volumetric renderer.

Counterpart of ``kaolin_tpu/render/mesh/deftet.py`` (reference
``deftet_sparse_render``): renders ALL per-pixel face intersections, depth
sorted, into padded (num_pixels, knum) buffers instead of only the closest.

The search takes no gradient. It orders a pixel's hits by depth, closest
(largest z) first, and equal depths by ascending face id, as JAX's
``lax.top_k`` does: a pixel on an edge two faces share gives two equal z,
and ``torch.topk`` promises no order for ties, so the search takes the
first ``knum`` of a stable descending sort. Scenes with more than
``face_chunk`` faces fold a running per-pixel top ``knum`` over chunks of
faces in ascending order, ``pixel_chunk`` pixels at a time: the ties keep
their order across the fold, so its ids equal one dense pass's. The
features are then re-interpolated differentiably from the selected faces,
so autograd gives the backward in the features and the image-plane
vertices.
"""

import torch

from kaolin_tpu_torch.render.mesh.rasterization import _barycentrics

__all__ = ["deftet_sparse_render"]


def _hit_depths(pixel_coords, render_ranges, face_vertices_z,
                face_vertices_image, valid_faces, eps):
    """(P, F) interpolated depths, -inf where the pixel misses the face."""
    px = pixel_coords[:, 0:1]  # (P, 1)
    py = pixel_coords[:, 1:2]
    w0, w1, w2 = _barycentrics(px, py, face_vertices_image[None], eps)
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    z = (w0 * face_vertices_z[None, :, 0] + w1 * face_vertices_z[None, :, 1]
         + w2 * face_vertices_z[None, :, 2])  # (P, F)
    in_range = (z >= render_ranges[:, 0:1]) & (z <= render_ranges[:, 1:2])
    hit = inside & in_range & valid_faces[None]
    return torch.where(hit, z, -torch.inf)


def _top(z, idx, k):
    """The ``k`` largest of each row of ``z`` (P, N) and their ``idx``,
    largest first, equal values in their order in the row."""
    top_z, pos = torch.sort(z, dim=1, descending=True, stable=True)
    return top_z[:, :k], torch.gather(idx, 1, pos[:, :k])


def _pad_knum(top_idx, knum, k):
    if k < knum:
        top_idx = torch.nn.functional.pad(top_idx, (0, knum - k), value=-1)
    return top_idx


def _render_single(pixel_coords, render_ranges, face_vertices_z,
                   face_vertices_image, valid_faces, knum, eps,
                   face_chunk=1024, pixel_chunk=8192):
    """Unbatched search → (P, knum) int64 face ids (-1 padded), closest
    first. Small face counts take one dense (P, F) pass; larger ones the
    fold over face chunks, ``pixel_chunk`` pixels at a time: peak memory
    O(pixel_chunk · (knum + face_chunk)) instead of O(P · F)."""
    p = pixel_coords.shape[0]
    f = face_vertices_z.shape[0]
    device = face_vertices_z.device
    k = min(knum, f)
    if f <= face_chunk or p <= 1:
        z_masked = _hit_depths(pixel_coords, render_ranges, face_vertices_z,
                               face_vertices_image, valid_faces, eps)
        ids = torch.arange(f, device=device).expand(p, f)
        top_z, top_idx = _top(z_masked, ids, k)
        top_idx = torch.where(torch.isfinite(top_z), top_idx, -1)
        return _pad_knum(top_idx, knum, k)

    out = []
    for s in range(0, p, pixel_chunk):
        pc = pixel_coords[s:s + pixel_chunk]
        rr = render_ranges[s:s + pixel_chunk]
        top_z = torch.full((pc.shape[0], k), -torch.inf,
                           dtype=face_vertices_z.dtype, device=device)
        top_idx = torch.full((pc.shape[0], k), -1, dtype=torch.long,
                             device=device)
        for c in range(0, f, face_chunk):
            z_m = _hit_depths(pc, rr, face_vertices_z[c:c + face_chunk],
                              face_vertices_image[c:c + face_chunk],
                              valid_faces[c:c + face_chunk], eps)
            ids = torch.arange(c, c + z_m.shape[1],
                               device=device).expand_as(z_m)
            top_z, top_idx = _top(torch.cat([top_z, z_m], dim=1),
                                  torch.cat([top_idx, ids], dim=1), k)
        out.append(torch.where(torch.isfinite(top_z), top_idx, -1))
    return _pad_knum(torch.cat(out), knum, k)


def deftet_sparse_render(pixel_coords, render_ranges, face_vertices_z,
                         face_vertices_image, face_features, knum=300,
                         valid_faces=None, eps=1e-8, face_chunk=1024,
                         pixel_chunk=8192):
    """Render all intersections per pixel, depth sorted.

    Args:
        pixel_coords: (B, P, 2) image-plane coordinates.
        render_ranges: (B, P, 2) the [near, far] z of each pixel.
        face_vertices_z: (B, F, 3) camera-space z per face vertex.
        face_vertices_image: (B, F, 3, 2) image-plane coordinates.
        face_features: (B, F, 3, D) or a list of such.
        knum: intersections kept per pixel.
        valid_faces: optional (B, F) bool.
        face_chunk, pixel_chunk: the streamed search's block (above
            ``face_chunk`` faces).

    Returns:
        (features (B, P, knum, D) [or a list], face_idx (B, P, knum) int64,
        −1 past a pixel's last hit). Differentiable in
        ``face_vertices_image`` and ``face_features``.
    """
    is_list = isinstance(face_features, (list, tuple))
    feats = list(face_features) if is_list else [face_features]
    feat_dims = [x.shape[-1] for x in feats]
    features = torch.cat(feats, dim=-1)
    b, f = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_faces = torch.ones((b, f), dtype=torch.bool,
                                 device=face_vertices_z.device)

    with torch.no_grad():
        face_idx = torch.stack([
            _render_single(pixel_coords[i], render_ranges[i],
                           face_vertices_z[i], face_vertices_image[i],
                           valid_faces[i].bool(), knum, eps, face_chunk,
                           pixel_chunk) for i in range(b)])

    p = face_idx.shape[1]
    safe = face_idx.clamp(min=0).reshape(b, -1, 1)
    sel_v = torch.gather(face_vertices_image.reshape(b, f, 6), 1,
                         safe.expand(-1, -1, 6)).reshape(b, p, knum, 3, 2)
    d = features.shape[-1]
    sel_feat = torch.gather(features.reshape(b, f, 3 * d), 1,
                            safe.expand(-1, -1, 3 * d)).reshape(
        b, p, knum, 3, d)

    px = pixel_coords[..., None, 0]
    py = pixel_coords[..., None, 1]
    w0, w1, w2 = _barycentrics(px, py, sel_v, eps)
    out = (w0[..., None] * sel_feat[..., 0, :]
           + w1[..., None] * sel_feat[..., 1, :]
           + w2[..., None] * sel_feat[..., 2, :])
    out = torch.where((face_idx >= 0)[..., None], out, 0.0)

    if is_list:
        return list(torch.split(out, feat_dims, dim=-1)), face_idx
    return out, face_idx
