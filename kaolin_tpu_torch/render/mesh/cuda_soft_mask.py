"""CUDA soft-silhouette kernels (``csrc/soft_mask.cu``), counterpart of
``kaolin_tpu/render/mesh/pallas_soft_mask.py``.

Their plain PyTorch versions are
:func:`kaolin_tpu_torch.render.mesh.dibr.soft_mask_plain` (forward) and its
autograd (backward); ``dibr._SoftMask`` calls these wrappers for CUDA
tensors and the plain versions for CPU tensors.

Counters (:mod:`kaolin_tpu_torch.utils.profiling`): the launches of each
(``FWD_LAUNCHES``, ``FWD_WITH_FACE_IDX``, ``BWD_LAUNCHES``), and while the
profiler runs the (pixel, face) pairs each visits,
``render.mesh.soft_mask_fwd.pairs`` and ``render.mesh.soft_mask_bwd.pairs``
(``cuda_rasterize.PAIRS``).
"""

import ctypes

import torch

from kaolin_tpu_torch.render.mesh.cuda_rasterize import box_work, pair_counters
from kaolin_tpu_torch.utils import cuda_build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P] * 4 + [_I] * 4 + [_F] * 6 + [_P, _I, _P]
_BWD_ARGTYPES = [_P] * 4 + [_I] * 5 + [_F] * 7 + [_P, _I, _P]
FWD_LAUNCHES = "render.mesh.soft_mask_fwd.launches"
FWD_WITH_FACE_IDX = "render.mesh.soft_mask_fwd.launches_with_face_idx"
BWD_LAUNCHES = "render.mesh.soft_mask_bwd.launches"
for _name in (FWD_LAUNCHES, FWD_WITH_FACE_IDX, BWD_LAUNCHES):
    profiling.count(_name, 0)


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


def _check_face_idx(face_idx, fvi, height, width):
    """Type, shape and device first, so that they are checked on any
    device; then contiguity."""
    want = (fvi.shape[0], height, width)
    if face_idx.dtype != torch.int32:
        raise TypeError(f"face_idx must be torch.int32, got {face_idx.dtype}")
    if tuple(face_idx.shape) != want:
        raise ValueError(f"face_idx must have shape {want}, got "
                         f"{tuple(face_idx.shape)}")
    if face_idx.device != fvi.device:
        raise ValueError(f"face_idx must be on {fvi.device}, got "
                         f"{face_idx.device}")
    if not face_idx.is_contiguous():
        raise ValueError("face_idx must be contiguous")


def soft_mask_fwd_cuda(face_vertices_image, sigmainv, boxlen, multiplier,
                       height, width, face_idx=None):
    """allprob (B, H, W) = ∏ (1 − p) over in-box faces, on the card.
    ``face_vertices_image`` is (B, F, 3, 2) float32, already scaled by
    ``multiplier``.

    ``face_idx``: optional (B, H, W) int32 face ids of the rasterizer on the
    same device. Where an id is ≥ 0 the kernel writes 1.0 and computes
    nothing; every other pixel gets the same bits as without it."""
    if height <= 0 or width <= 0:
        raise ValueError(f"image size must be positive, got {height}x{width}")
    if face_idx is not None:
        _check_face_idx(face_idx, face_vertices_image, height, width)
    b, f = _check_faces(face_vertices_image)
    device = face_vertices_image.device
    out = torch.empty((b, height, width), dtype=torch.float32, device=device)
    work = box_work(b, f, device)
    fn = cuda_build.function("kaolin_soft_mask_fwd", _FWD_ARGTYPES)
    counters, reset = pair_counters(b, f, device)
    with torch.cuda.device(device):
        status = fn(cuda_build.ptr(face_vertices_image),
                    None if face_idx is None else cuda_build.ptr(face_idx),
                    cuda_build.ptr(work), cuda_build.ptr(out), b, f, height,
                    width,
                    *_scalars(sigmainv, boxlen, multiplier, height, width),
                    4.0 * multiplier * multiplier, counters, int(reset),
                    cuda_build.stream(face_vertices_image))
    cuda_build.check(status, "kaolin_soft_mask_fwd")
    profiling.count(FWD_LAUNCHES)
    if face_idx is not None:
        profiling.count(FWD_WITH_FACE_IDX)
    return out


def soft_mask_bwd_cuda(face_vertices_image, ga, sigmainv, boxlen, multiplier,
                       height, width):
    """Gradient with respect to the scaled ``face_vertices_image``
    (B, F, 3, 2), given ``ga = grad(allprob) * allprob`` (B, H, W).

    Face-major, with no atomics: the same inputs give the same bits."""
    b, f = _check_faces(face_vertices_image)
    cuda_build.require(ga, "ga", (b, height, width), torch.float32)
    grad = torch.empty_like(face_vertices_image)
    # band slots: a face takes one per 4,096 pixels of its box; where they
    # do not fit, the kernel's plan makes the bands larger
    cap = 2 * b * f + 4096
    # per face its pixel range (4), first band and band count, then
    # (bands, band_px), the (face, band) of each slot and its 6 float32 sums
    work = torch.empty(6 * b * f + 2 + 8 * cap, dtype=torch.int32,
                       device=face_vertices_image.device)
    fn = cuda_build.function("kaolin_soft_mask_bwd", _BWD_ARGTYPES)
    counters, reset = pair_counters(b, f, face_vertices_image.device)
    with torch.cuda.device(face_vertices_image.device):
        status = fn(cuda_build.ptr(face_vertices_image), cuda_build.ptr(ga),
                    cuda_build.ptr(grad), cuda_build.ptr(work), b, f, height,
                    width, cap,
                    *_scalars(sigmainv, boxlen, multiplier, height, width),
                    sigmainv / (multiplier * multiplier),
                    4.0 * multiplier * multiplier, counters, int(reset),
                    cuda_build.stream(face_vertices_image))
    cuda_build.check(status, "kaolin_soft_mask_bwd")
    profiling.count(BWD_LAUNCHES)
    return grad
