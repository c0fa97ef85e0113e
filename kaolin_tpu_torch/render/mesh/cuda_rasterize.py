"""CUDA winner search (``csrc/rasterize.cu``), counterpart of
``kaolin_tpu/render/mesh/pallas_rasterize.py``.

Its plain PyTorch version is
:func:`kaolin_tpu_torch.render.mesh.rasterization.rasterize_search_plain`;
:func:`~kaolin_tpu_torch.render.mesh.rasterization.rasterize` calls this
wrapper for CUDA tensors and the plain version for CPU tensors.

Counters (:mod:`kaolin_tpu_torch.utils.profiling`): ``LAUNCHES``, and while
the profiler runs the (pixel, face) pairs the search visits,
``render.mesh.winner.pairs`` (``PAIRS``, ``csrc/tiles.cuh``).
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build, profiling

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 \
    + [_P, ctypes.c_int, _P]
# faces per group box of the kernels' pre-pass (csrc/tiles.cuh, kGroup), and
# the side of both mesh kernels' pixel tiles (kWinnerTile, kSoftTile)
GROUP = 32
TILE = 8
# the mesh kernels' device counters, in the order csrc/tiles.cuh takes them:
# the (pixel, face) pairs #1, #2 and #3 visit
PAIRS = ("render.mesh.winner.pairs", "render.mesh.soft_mask_fwd.pairs",
         "render.mesh.soft_mask_bwd.pairs")
LAUNCHES = "render.mesh.winner.launches"
profiling.count(LAUNCHES, 0)


def pair_counters(b, f, device):
    """(address, reset) of the pair counters for a launch over ``b`` x
    ``f`` faces: (None, False) while the profiler is off or where there is
    no face, so that no pre-pass runs to zero them."""
    if b * f == 0:
        return None, False
    return profiling.device_counters(PAIRS, device)


def box_work(b, f, device):
    """Scratch of the kernels' pre-pass: each face's box, then the box of
    each group of ``GROUP`` faces, float32 (b * (f + ceil(f / GROUP)), 4)."""
    return torch.empty((b * (f + -(-f // GROUP)), 4), dtype=torch.float32,
                       device=device)


def rasterize_search_cuda(face_vertices_z, face_vertices_image, valid_mask,
                          multiplier, eps, height, width):
    """Winner search on the card → (B, H, W) int32 face ids, −1 on a miss.

    Args:
        face_vertices_z: (B, F, 3) float32.
        face_vertices_image: (B, F, 3, 2) float32, already scaled by
            ``multiplier``.
        valid_mask: (B, F) bool.
        multiplier, eps, height, width: as in ``rasterize``.

    All tensors are contiguous and on one CUDA device. Launches a pre-pass
    (each face's and each group of faces' box) and the search on PyTorch's
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
    work = box_work(b, f, out.device)
    fn = cuda_build.function("kaolin_rasterize_winner", _ARGTYPES)
    counters, reset = pair_counters(b, f, out.device)
    with torch.cuda.device(face_vertices_z.device):
        status = fn(cuda_build.ptr(face_vertices_z),
                    cuda_build.ptr(face_vertices_image),
                    cuda_build.ptr(valid_mask),
                    cuda_build.ptr(work),
                    cuda_build.ptr(out),
                    b, f, height, width, multiplier / width,
                    multiplier / height, eps, counters, int(reset),
                    cuda_build.stream(face_vertices_z))
    cuda_build.check(status, "kaolin_rasterize_winner")
    profiling.count(LAUNCHES)
    return out
