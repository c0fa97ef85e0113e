"""CUDA winner search (``csrc/rasterize.cu``), counterpart of
``kaolin_tpu/render/mesh/pallas_rasterize.py``.

Its plain PyTorch version is
:func:`kaolin_tpu_torch.render.mesh.rasterization.rasterize_search_plain`;
:func:`~kaolin_tpu_torch.render.mesh.rasterization.rasterize` calls this
wrapper for CUDA tensors and the plain version for CPU tensors.
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P] + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [_P]


def rasterize_search_cuda(face_vertices_z, face_vertices_image, valid_mask,
                          multiplier, eps, height, width):
    """Winner search on the card → (B, H, W) int32 face ids, −1 on a miss.

    Args:
        face_vertices_z: (B, F, 3) float32.
        face_vertices_image: (B, F, 3, 2) float32, already scaled by
            ``multiplier``.
        valid_mask: (B, F) bool.
        multiplier, eps, height, width: as in ``rasterize``.

    All tensors are contiguous and on one CUDA device. Launches on PyTorch's
    current stream and does not synchronise.
    """
    if height <= 0 or width <= 0:
        raise ValueError(f"image size must be positive, got {height}x{width}")
    b, f = face_vertices_z.shape[:2]
    cuda_build.require(face_vertices_z, "face_vertices_z", (b, f, 3),
                       torch.float32)
    cuda_build.require(face_vertices_image, "face_vertices_image",
                       (b, f, 3, 2), torch.float32)
    cuda_build.require(valid_mask, "valid_mask", (b, f), torch.bool)
    out = torch.empty((b, height, width), dtype=torch.int32,
                      device=face_vertices_z.device)
    fn = cuda_build.function("kaolin_rasterize_winner", _ARGTYPES)
    with torch.cuda.device(face_vertices_z.device):
        status = fn(cuda_build.ptr(face_vertices_z),
                    cuda_build.ptr(face_vertices_image),
                    cuda_build.ptr(valid_mask), cuda_build.ptr(out),
                    b, f, height, width, multiplier / width,
                    multiplier / height, eps,
                    cuda_build.stream(face_vertices_z))
    cuda_build.check(status, "kaolin_rasterize_winner")
    rasterize_search_cuda.launches += 1
    return out


rasterize_search_cuda.launches = 0
