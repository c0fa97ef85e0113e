"""CUDA soft-silhouette kernels (``csrc/soft_mask.cu``), counterpart of
``kaolin_tpu/render/mesh/pallas_soft_mask.py``.

Their plain PyTorch versions are
:func:`kaolin_tpu_torch.render.mesh.dibr.soft_mask_plain` (forward) and its
autograd (backward); ``dibr._SoftMask`` calls these wrappers for CUDA
tensors and the plain versions for CPU tensors.
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P, _P] + [_I] * 4 + [_F] * 6 + [_P]
_BWD_ARGTYPES = [_P, _P, _P] + [_I] * 4 + [_F] * 7 + [_P]


def _scalars(sigmainv, boxlen, multiplier, height, width):
    """Constants in the order the C entries take them, rounded to float32
    as the plain version rounds them."""
    return (multiplier / width, multiplier / height, boxlen * multiplier,
            -sigmainv, multiplier * multiplier)


def _check_faces(fvi):
    if fvi.dim() != 4:
        raise ValueError("face_vertices_image must be (B, F, 3, 2)")
    b, f = fvi.shape[:2]
    cuda_build.require(fvi, "face_vertices_image", (b, f, 3, 2),
                       torch.float32)
    return b, f


def soft_mask_fwd_cuda(face_vertices_image, sigmainv, boxlen, multiplier,
                       height, width):
    """allprob (B, H, W) = ∏ (1 − p) over in-box faces, on the card.
    ``face_vertices_image`` is (B, F, 3, 2) float32, already scaled by
    ``multiplier``."""
    if height <= 0 or width <= 0:
        raise ValueError(f"image size must be positive, got {height}x{width}")
    b, f = _check_faces(face_vertices_image)
    out = torch.empty((b, height, width), dtype=torch.float32,
                      device=face_vertices_image.device)
    fn = cuda_build.function("kaolin_soft_mask_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(face_vertices_image.device):
        status = fn(cuda_build.ptr(face_vertices_image), cuda_build.ptr(out),
                    b, f, height, width,
                    *_scalars(sigmainv, boxlen, multiplier, height, width),
                    4.0 * multiplier * multiplier,
                    cuda_build.stream(face_vertices_image))
    cuda_build.check(status, "kaolin_soft_mask_fwd")
    soft_mask_fwd_cuda.launches += 1
    return out


def soft_mask_bwd_cuda(face_vertices_image, ga, sigmainv, boxlen, multiplier,
                       height, width):
    """Gradient with respect to the scaled ``face_vertices_image``
    (B, F, 3, 2), given ``ga = grad(allprob) * allprob`` (B, H, W)."""
    b, f = _check_faces(face_vertices_image)
    cuda_build.require(ga, "ga", (b, height, width), torch.float32)
    grad = torch.zeros_like(face_vertices_image)
    fn = cuda_build.function("kaolin_soft_mask_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(face_vertices_image.device):
        status = fn(cuda_build.ptr(face_vertices_image), cuda_build.ptr(ga),
                    cuda_build.ptr(grad), b, f, height, width,
                    *_scalars(sigmainv, boxlen, multiplier, height, width),
                    sigmainv / (multiplier * multiplier),
                    4.0 * multiplier * multiplier,
                    cuda_build.stream(face_vertices_image))
    cuda_build.check(status, "kaolin_soft_mask_bwd")
    soft_mask_bwd_cuda.launches += 1
    return grad


soft_mask_fwd_cuda.launches = 0
soft_mask_bwd_cuda.launches = 0
