"""General mesh ops: indexing, adjacency, laplacian, vertex normals.

Counterpart of ``kaolin_tpu/ops/mesh/mesh.py``. Topology (``faces``) is
numpy, a list or a tensor; adjacency and the laplacian are built on the host
in numpy, as there, and handed back as tensors on ``device``, else where
``faces`` lies, else on the card. Per-vertex averages use
``index_add`` where JAX uses ``segment_sum``.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.batch import host
from kaolin_tpu_torch.utils.backend import input_device

__all__ = [
    "index_vertices_by_faces",
    "adjacency_matrix",
    "uniform_laplacian",
    "compute_vertex_normals",
    "average_face_vertex_features",
    "unindex_vertices_by_faces",
]


def faces_on(faces, device):
    """Faces (numpy, list or tensor) → an int64 tensor on ``device``."""
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(faces), dtype=torch.long,
                           device=device)


def _device_of(faces, device):
    """``device``, else the device of ``faces`` when it is a tensor, else
    the card, raising without one."""
    return input_device(faces, device, "the mesh topology op")


def index_vertices_by_faces(vertices_features, faces):
    """Per-vertex (B, V, D) → per-vertex-per-face (B, F, FSz, D)."""
    assert vertices_features.ndim == 3
    faces = faces_on(faces, vertices_features.device)
    assert faces.ndim == 2
    return vertices_features[:, faces]


def _unique_edges(faces):
    faces = host(faces)
    rolled = np.roll(faces, 1, axis=-1)
    fwd = np.stack([faces, rolled], axis=-1).reshape(-1, 2)
    bwd = np.stack([rolled, faces], axis=-1).reshape(-1, 2)
    return np.unique(np.concatenate([fwd, bwd], axis=0), axis=0)


def adjacency_matrix(num_vertices, faces, sparse=False, device=None):
    """Vertex adjacency (V, V) float32. ``sparse`` returns the COO pair
    (indices (2, E) int64, values (E,) float32) instead of a dense tensor.
    On ``device``, else where ``faces`` lies, else on the card."""
    device = _device_of(faces, device)
    idx = _unique_edges(faces)
    if sparse:
        return (torch.as_tensor(idx.T.copy(), device=device),
                torch.ones(idx.shape[0], dtype=torch.float32, device=device))
    adj = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    adj[idx[:, 0], idx[:, 1]] = 1.0
    return torch.as_tensor(adj, device=device)


def uniform_laplacian(num_vertices, faces, device=None):
    """Uniform laplacian (V, V) float32, dense: 1/deg(i) at the neighbours
    j of i, −1 on the diagonal. On ``device``, else where ``faces`` lies,
    else on the card."""
    adj = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    idx = _unique_edges(faces)
    adj[idx[:, 0], idx[:, 1]] = 1.0
    deg = adj.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        lap = np.where(deg > 0, adj / deg, 0.0).astype(np.float32)
    np.fill_diagonal(lap, -1.0)
    return torch.as_tensor(lap, device=_device_of(faces, device))


def average_face_vertex_features(faces, face_features, num_vertices=None):
    """Average per-face-vertex features (B, F, FSz, D) into per-vertex
    features (B, V, D)."""
    seg = faces_on(faces, face_features.device).reshape(-1)
    if num_vertices is None:
        num_vertices = int(seg.max()) + 1
    b, d = face_features.shape[0], face_features.shape[-1]
    flat = face_features.reshape(b, -1, d)
    sums = flat.new_zeros(b, num_vertices, d).index_add(1, seg, flat)
    counts = flat.new_zeros(num_vertices).index_add(
        0, seg, flat.new_ones(seg.shape[0]))
    return sums / torch.clamp(counts, min=1.0)[:, None]


def compute_vertex_normals(faces, face_normals, num_vertices=None):
    """Per-vertex normals: the average of the incident faces' normals."""
    return average_face_vertex_features(faces, face_normals, num_vertices)


def unindex_vertices_by_faces(face_vertices):
    """Inverse of :func:`index_vertices_by_faces`: the per-face vertices
    flattened into one vertex per corner, and trivial faces → (vertices
    (..., F·3, D), faces (F, 3) int64)."""
    b_shape = face_vertices.shape[:-3]
    nf = face_vertices.shape[-3]
    vertices = face_vertices.reshape(tuple(b_shape) + (nf * 3,)
                                     + tuple(face_vertices.shape[-1:]))
    faces = torch.arange(nf * 3, dtype=torch.int64,
                         device=face_vertices.device).reshape(nf, 3)
    return vertices, faces
