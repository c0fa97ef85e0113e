"""I/O helpers: error handlers, heterogeneous-mesh handlers and images.

Counterpart of ``kaolin_tpu/io/utils.py``. Images are read and written
through Pillow, as the JAX package reads and writes them; Pillow is
imported at first use, so the package imports without it.
"""

import io as _io
import os

import numpy as np
import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "NonHomogeneousMeshError",
    "heterogeneous_mesh_handler_skip",
    "heterogeneous_mesh_handler_naive_homogenize",
    "mesh_handler_naive_triangulate",
    "default_error_handler",
    "skip_error_handler",
    "ignore_error_handler",
    "create_missing_materials_error_handler",
]


class NonHomogeneousMeshError(Exception):
    """Faces have varying vertex counts and no handler was given."""


def default_error_handler(error, **kwargs):
    raise error


def skip_error_handler(error, **kwargs):
    pass


def ignore_error_handler(error, **kwargs):
    pass


def create_missing_materials_error_handler(error, **kwargs):
    """Returns a dummy material dict for missing materials."""
    from kaolin_tpu_torch.io.obj import MaterialNotFoundError
    if isinstance(error, MaterialNotFoundError):
        return {"material_name": kwargs.get("material_name", "missing")}
    raise error


def heterogeneous_mesh_handler_skip(*args, **kwargs):
    """Skip heterogeneous meshes (returns None)."""
    return None


def mesh_handler_naive_triangulate(vertices, face_vertex_counts, *features,
                                   face_assignments=None):
    """Triangulate a heterogeneous mesh by fanning each polygon
    (v0, v_i, v_i+1).

    Args:
        vertices: (V, 3) array.
        face_vertex_counts: (F,) vertex count per face.
        *features: flat per-face-vertex index/feature arrays to re-index.
        face_assignments: optional dict name → face ids (1D) or (N, 2)
            (start, end) rows, remapped to the triangulated faces: each id
            expands to its triangles, each row to its new range.

    Returns:
        (vertices, face_vertex_counts (all 3), *new_features[,
        face_assignments])
    """
    counts = np.asarray(face_vertex_counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    new_features = [[] for _ in features]
    old_to_new_start = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    num_tris = 0
    for i, c in enumerate(counts):
        old_to_new_start[i] = num_tris
        start = offsets[i]
        for k in range(1, c - 1):
            for fi, feat in enumerate(features):
                f = np.asarray(feat)
                new_features[fi].extend([f[start], f[start + k],
                                         f[start + k + 1]])
        num_tris += max(c - 2, 0)
    old_to_new_start[-1] = num_tris
    outs = [np.asarray(vertices), np.full(num_tris, 3, dtype=np.int64)]
    outs.extend(np.asarray(nf) for nf in new_features)
    if face_assignments is not None:
        new_assign = {}
        for k, v in face_assignments.items():
            v = np.asarray(v)
            if v.ndim == 2:
                new_assign[k] = old_to_new_start[v]
            else:
                ids = []
                for fid in v:
                    ids.extend(range(old_to_new_start[fid],
                                     old_to_new_start[fid + 1]))
                new_assign[k] = np.asarray(ids, dtype=np.int64)
        outs.append(new_assign)
    return tuple(outs)


# the older name of the handler
heterogeneous_mesh_handler_naive_homogenize = mesh_handler_naive_triangulate


def _pil():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _missing_pillow(what):
    return ImportError(f"{what} needs Pillow, which is not installed "
                       "(pip install pillow)")


def _open_image(source):
    """A Pillow image of a file path or of a file's bytes. Without Pillow
    an ImportError names the file."""
    in_memory = isinstance(source, (bytes, bytearray, memoryview))
    pil = _pil()
    if pil is None:
        raise _missing_pillow("reading an image from memory" if in_memory
                              else f"reading the image {os.fspath(source)}")
    return pil.open(_io.BytesIO(bytes(source)) if in_memory else source)


def _image_tensor(arr, device):
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device, "read_image"))


def read_image(path, device=None):
    """An image file → a tensor (H, W[, C]) on ``device`` (the CUDA device
    unless named): floats in [0, 1] for 8-bit files, else the file's own
    values."""
    return _image_tensor(np.array(_open_image(path)), device)


def read_image_from_buffer(data, device=None):
    """:func:`read_image` from the file's bytes."""
    return _image_tensor(np.array(_open_image(bytes(data))), device)


def _host(x):
    """A tensor or an array-like as a numpy array on the host (None stays
    None)."""
    if x is None or isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def write_image(image, path):
    """Save a float [0, 1] or uint8 image (H, W[, C]): floats are clipped
    and scaled by 255, then truncated."""
    arr = _host(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    pil = _pil()
    if pil is None:
        raise _missing_pillow(f"writing the image {os.fspath(path)}")
    pil.fromarray(arr).save(path)


class TextureExporter:
    """Callable that writes material textures next to an exported asset and
    returns the relative path to embed."""

    def __init__(self, base_dir, relative_dir="textures",
                 image_extension=".png"):
        self.base_dir = base_dir
        self.relative_dir = relative_dir
        self.image_extension = image_extension
        self._counts = {}

    def __call__(self, image, texture_name="texture"):
        idx = self._counts.get(texture_name, 0)
        self._counts[texture_name] = idx + 1
        suffix = "" if idx == 0 else f"_{idx}"
        rel = os.path.join(self.relative_dir,
                           f"{texture_name}{suffix}{self.image_extension}")
        full = os.path.join(self.base_dir, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        write_image(image, full)
        return rel
