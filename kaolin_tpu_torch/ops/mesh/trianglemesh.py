"""Triangle-mesh ops: areas, sampling, normals, subdivision, tangents.

Counterpart of ``kaolin_tpu/ops/mesh/trianglemesh.py``. Geometry (vertices)
is a tensor and everything is differentiable; topology (faces) is numpy, a
list or a tensor, and what is derived from it is computed on the host.
Random sampling takes a ``torch.Generator`` where JAX takes a key; the
draws come from the generator's device (the default generator's when it is
None) and are moved to the vertices' device.
"""

import math

import numpy as np
import torch

from kaolin_tpu_torch.ops.batch import get_first_idx, host, tile_to_packed
from kaolin_tpu_torch.ops.mesh.mesh import faces_on
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "face_areas",
    "packed_face_areas",
    "sample_points",
    "packed_sample_points",
    "face_normals",
    "subdivide_trianglemesh",
    "vertex_tangents",
    "uniform_laplacian_smoothing",
]


def _base_face_areas(v0, v1, v2):
    """Triangle areas: half the norm of the edges' cross product."""
    return 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)


def face_areas(vertices, faces):
    """Areas of each face: (B, V, 3) x (F, 3) → (B, F)."""
    fv = vertices[:, faces_on(faces, vertices.device)]     # (B, F, 3, 3)
    return _base_face_areas(fv[..., 0, :], fv[..., 1, :], fv[..., 2, :])


def _packed_face_vertices(vertices, first_idx_vertices, faces,
                          num_faces_per_mesh):
    offset = tile_to_packed(torch.as_tensor(
        host(first_idx_vertices)[:-1], dtype=torch.long,
        device=vertices.device), num_faces_per_mesh)
    return vertices[faces_on(faces, vertices.device) + offset]


def packed_face_areas(vertices, first_idx_vertices, faces,
                      num_faces_per_mesh):
    """Areas over packed meshes → (F_total,)."""
    fv = _packed_face_vertices(vertices, first_idx_vertices, faces,
                               num_faces_per_mesh)
    return _base_face_areas(fv[:, 0], fv[:, 1], fv[:, 2])


def _sample_barycentric(generator, shape, dtype, device):
    """w0, w1, w2 with the square-root trick for a uniform density."""
    gen_dev = generator.device if generator is not None else device
    u = torch.sqrt(torch.rand(shape, generator=generator, dtype=dtype,
                              device=gen_dev)).to(device)
    v = torch.rand(shape, generator=generator, dtype=dtype,
                   device=gen_dev).to(device)
    return 1.0 - u, u * (1.0 - v), u * v


def _choose_faces(generator, areas, num_samples):
    """Faces drawn with probability proportional to their areas, clipped
    below at 1e-30 (JAX's categorical over their logs) → (B, S) int32."""
    gen_dev = generator.device if generator is not None else areas.device
    weights = torch.clamp(areas.detach(), min=1e-30).to(gen_dev)
    choice = torch.multinomial(weights, num_samples, replacement=True,
                               generator=generator)
    return choice.to(device=areas.device, dtype=torch.int32)


def _interpolate(w, sel):
    w0, w1, w2 = w
    return w0 * sel[..., 0, :] + w1 * sel[..., 1, :] + w2 * sel[..., 2, :]


def sample_points(vertices, faces, num_samples, generator=None, areas=None,
                  face_features=None):
    """Sample points uniformly on the surfaces, faces weighted by area.

    Args:
        vertices: (B, V, 3).
        faces: (F, 3) int.
        num_samples: int.
        generator: a ``torch.Generator`` (JAX: the key), or None for the
            default generator.
        areas: optional precomputed (B, F).
        face_features: optional (B, F, 3, D) to interpolate.

    Returns:
        (points (B, S, 3), face_choices (B, S) int32[, features (B, S, D)]).
    """
    fv = vertices[:, faces_on(faces, vertices.device)]     # (B, F, 3, 3)
    if areas is None:
        areas = _base_face_areas(fv[..., 0, :], fv[..., 1, :], fv[..., 2, :])
    b = vertices.shape[0]
    face_choices = _choose_faces(generator, areas, num_samples)
    gather = face_choices.long()[..., None, None]
    sel = torch.take_along_dim(fv, gather, dim=1)           # (B, S, 3, 3)
    w = _sample_barycentric(generator, (b, num_samples, 1), vertices.dtype,
                            vertices.device)
    points = _interpolate(w, sel)
    if face_features is not None:
        ff = torch.take_along_dim(face_features, gather, dim=1)
        return points, face_choices, _interpolate(w, ff)
    return points, face_choices


def packed_sample_points(vertices, first_idx_vertices, faces,
                         num_faces_per_mesh, num_samples, generator=None,
                         areas=None):
    """Sample points over packed meshes → (points (B, S, 3), face ids
    into the packed faces (B, S) int32)."""
    from kaolin_tpu_torch.ops.batch import packed_to_padded
    nf = host(num_faces_per_mesh)
    b = nf.shape[0]
    fv = _packed_face_vertices(vertices, first_idx_vertices, faces, nf)
    if areas is None:
        areas = _base_face_areas(fv[:, 0], fv[:, 1], fv[:, 2])
    first_idx_faces = get_first_idx(nf)
    padded_areas = packed_to_padded(areas.reshape(-1, 1), nf.reshape(-1, 1),
                                    first_idx_faces, 0.0).squeeze(-1)
    face_choices = _choose_faces(generator, padded_areas, num_samples)
    merged = face_choices + torch.as_tensor(
        first_idx_faces[:-1], dtype=torch.int32,
        device=vertices.device).reshape(-1, 1)
    sel = fv[merged.reshape(-1).long()].reshape(b, num_samples, 3, 3)
    w = _sample_barycentric(generator, (b, num_samples, 1), vertices.dtype,
                            vertices.device)
    return _interpolate(w, sel), merged


def face_normals(face_vertices, unit=False):
    """Normals of faces (B, F, 3, 3) → (B, F, 3), left-hand rule; a unit
    normal divides by the norm + 1e-10."""
    e0 = face_vertices[:, :, 1] - face_vertices[:, :, 0]
    e1 = face_vertices[:, :, 2] - face_vertices[:, :, 0]
    n = torch.linalg.cross(e0, e1)
    if unit:
        n = n / (torch.linalg.vector_norm(n, dim=2, keepdim=True) + 1e-10)
    return n


def _get_alpha(n):
    """Loop-subdivision weight per vertex valence."""
    alpha = (5.0 / 8 - (3.0 / 8 + 1.0 / 4 * np.cos(2 * math.pi / n)) ** 2) / n
    return np.where(n == 3, 3.0 / 16.0, alpha)


def _segment_sum(values, ids, num):
    """Sums of (B, E, D) rows into (B, num, D) by the (E,) ids."""
    out = values.new_zeros(values.shape[0], num, values.shape[-1])
    return out.index_add(1, ids, values)


def subdivide_trianglemesh(vertices, faces, iterations, alpha=None):
    """Loop subdivision with an optional learnable per-vertex alpha.

    The topology (edges, valences, new faces) is computed on the host in
    numpy; the positions stay tensors, so gradients flow through the
    (1 − alpha)·v + alpha/n·Σ neighbours update and the edge points.

    Returns (new_vertices (B, V', 3), new_faces (F·4^it, 3) int64 tensor).
    """
    init_alpha = alpha   # the automatic alpha is recomputed each iteration
    dev, dt = vertices.device, vertices.dtype
    for _ in range(iterations):
        if init_alpha is None:
            alpha = None
        faces_np = host(faces)
        b, v = vertices.shape[0], vertices.shape[1]
        f = faces_np.shape[0]

        edges = faces_np[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
        edges_sorted = np.sort(edges, axis=-1)
        all_edges_face_idx = np.repeat(np.arange(f), 3)
        edges_ex2, inverse_indices, counts = np.unique(
            edges_sorted, axis=0, return_inverse=True, return_counts=True)
        inverse_indices = inverse_indices.reshape(-1)
        e = edges_ex2.shape[0]

        adj_idx = np.unique(np.concatenate([edges_ex2, edges_ex2[:, ::-1]],
                                           axis=0), axis=0)
        n_neighbors = np.bincount(adj_idx[:, 0],
                                  minlength=v).astype(np.float64)

        if alpha is None:
            alpha_v = torch.as_tensor(
                (_get_alpha(np.clip(n_neighbors, 1, None))
                 * n_neighbors)[None, :, None], dtype=dt, device=dev)
        else:
            alpha_v = alpha[..., None] if alpha.ndim == 2 else alpha

        def ids(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long,
                                   device=dev)

        adj_sum = _segment_sum(vertices[:, ids(adj_idx[:, 1]), :],
                               ids(adj_idx[:, 0]), v)
        n_dev = torch.as_tensor(np.clip(n_neighbors, 1, None)[None, :, None],
                                dtype=dt, device=dev)
        vertices_new = (1 - alpha_v) * vertices + alpha_v / n_dev * adj_sum

        mask_e = counts == 2
        ends = ids(edges_ex2.reshape(-1))
        edge_points = vertices[:, ends, :].reshape(b, e, 2, 3).mean(dim=2)
        alpha_points = alpha_v[:, ends, :].reshape(
            alpha_v.shape[0], e, 2, 1).mean(dim=2)
        if mask_e.any():
            # an interior edge: the mean of the 6 corners of its 2 faces and
            # its 2 ends
            sel_rows = np.where(mask_e[inverse_indices])[0]
            order = np.argsort(inverse_indices[sel_rows], kind="stable")
            grouped = all_edges_face_idx[sel_rows][order]
            edges_face_idx = np.stack([grouped[::2], grouped[1::2]], axis=-1)
            interior = ids(np.where(mask_e)[0])
            faces_of_edges = faces_np[edges_face_idx.reshape(-1)].reshape(
                -1, 6)
            vert8 = ids(np.concatenate([faces_of_edges, edges_ex2[mask_e]],
                                       axis=1).reshape(-1))
            ev = vertices[:, vert8, :].reshape(b, -1, 8, 3).mean(dim=2)
            eav = alpha_v[:, vert8, :].reshape(
                alpha_v.shape[0], -1, 8, 1).mean(dim=2)
            edge_points = edge_points.index_copy(1, interior, ev)
            alpha_points = alpha_points.index_copy(1, interior, eav)

        vertices = torch.cat([vertices_new, edge_points], dim=1)
        alpha = torch.cat([alpha_v, alpha_points], dim=1)[..., 0]

        edges_fx3 = inverse_indices.reshape(f, 3) + v
        faces6 = np.concatenate([faces_np, edges_fx3], axis=1)
        faces = faces6[:, [[1, 4, 3], [0, 3, 5], [2, 5, 4],
                           [5, 3, 4]]].reshape(-1, 3)
    return vertices, torch.as_tensor(host(faces), dtype=torch.int64,
                                     device=dev)


def vertex_tangents(faces, face_vertices, face_uvs, vertex_normals):
    """Per-vertex tangents from UVs, for normal mapping: faces (F, 3),
    face_vertices (F, 3, 3), face_uvs (F, 3, 2), vertex_normals (V, 3)
    → (V, 3)."""
    faces = faces_on(faces, vertex_normals.device)
    uve1 = face_uvs[:, 1] - face_uvs[:, 0]
    uve2 = face_uvs[:, 2] - face_uvs[:, 0]
    pe1 = face_vertices[:, 1] - face_vertices[:, 0]
    pe2 = face_vertices[:, 2] - face_vertices[:, 0]
    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0] * uve2[..., 1] - uve1[..., 1] * uve2[..., 0]
    denom = torch.where(denom > 0.0, clip(denom, 1e-6, None),
                        clip(denom, None, -1e-6))
    tang = nom / denom[..., None]
    tangents = torch.zeros_like(vertex_normals)
    for i in range(3):
        tangents = tangents.index_add(0, faces[:, i], tang)

    def unit(x):
        return x / clip(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                        1e-12, None)

    tangents = unit(tangents)
    tangents = tangents - torch.sum(tangents * vertex_normals, dim=-1,
                                    keepdim=True) * vertex_normals
    return unit(tangents)


def uniform_laplacian_smoothing(vertices, faces):
    """Re-export of :func:`kaolin_tpu_torch.metrics.trianglemesh.
    uniform_laplacian_smoothing`."""
    from kaolin_tpu_torch.metrics.trianglemesh import (
        uniform_laplacian_smoothing as f,
    )
    return f(vertices, faces)
