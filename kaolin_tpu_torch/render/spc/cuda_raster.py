"""CUDA SPC raster kernels (``csrc/raster.cu``), counterpart of the Pallas
kernels of ``kaolin_tpu/render/spc/raster.py``.

Their plain PyTorch versions are
:func:`kaolin_tpu_torch.render.spc.raster.raster_tiles_plain` and
:func:`~kaolin_tpu_torch.render.spc.raster.untile_plain`; the raster calls
these wrappers for CUDA tensors and the plain versions for CPU tensors.
Their launches are the counters ``RASTER_LAUNCHES`` and ``UNTILE_LAUNCHES``
of :mod:`kaolin_tpu_torch.utils.profiling`.
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_RASTER_ARGTYPES = [_P] * 9 + [_I] * 6 + [_F] * 2 + [_P]
_UNTILE_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P]
# four threads per pixel of a tile, at most 1024 threads a block
MAX_TILE_PX = 16
# the level-3 cells staged in shared memory
_MAX_BOXES = 512
RASTER_LAUNCHES = "render.spc.raster_tiles.launches"
UNTILE_LAUNCHES = "render.spc.untile.launches"
profiling.count(RASTER_LAUNCHES, 0)
profiling.count(UNTILE_LAUNCHES, 0)


def _tiles(height, width, tile_px):
    if not 1 <= tile_px <= MAX_TILE_PX:
        raise ValueError(f"tile_px must be in [1, {MAX_TILE_PX}], "
                         f"got {tile_px}")
    if height <= 0 or width <= 0 or height % tile_px or width % tile_px:
        raise ValueError(f"{width}x{height} is not a whole number of "
                         f"{tile_px}-pixel tiles")
    return height // tile_px, width // tile_px


def _same_device(tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devices))}")


def raster_tiles_cuda(tab, counts, dz, cam, l3boxes, units, uaabb, *, width,
                      height, tile_px):
    """The tile kernel on the card → (depth (T, P) float32, id (T, P)
    int32), 3e38 and -1 where no leaf is hit.

    Args:
        tab: (c_cap, T) int32 unit table, ``uid << 16 | zq``.
        counts: (T,) int32 units binned to each tile, at most ``c_cap``.
        dz: 0-dim float32 depth quantum.
        cam: (19,) float32: R row-major, t, tan_h, tan_v, x0, y0, the ray
            origin.
        l3boxes: (M, 8) float32, M a multiple of 8 and at most 512.
        units: (U, 8, 128) float32, 16-byte aligned (the kernel copies
            whole units with cp.async.bulk).
        uaabb: (U, 8) float32 tight unit boxes, 16-byte aligned.
        width, height, tile_px: the image and its square tiles.

    All tensors are contiguous and on one CUDA device. Launches on
    PyTorch's current stream and does not synchronise.
    """
    ty_n, tx_n = _tiles(height, width, tile_px)
    c_cap, t_n = tab.shape
    m = l3boxes.shape[0]
    if t_n != ty_n * tx_n:
        raise ValueError(f"tab has {t_n} tiles, the image {ty_n * tx_n}")
    if m > _MAX_BOXES or m % 8:
        raise ValueError(f"l3boxes must hold a multiple of 8 and at most "
                         f"{_MAX_BOXES} rows, got {m}")
    cuda_build.require(tab, "tab", (c_cap, t_n), torch.int32)
    cuda_build.require(counts, "counts", (t_n,), torch.int32)
    cuda_build.require(dz, "dz", (), torch.float32)
    cuda_build.require(cam, "cam", (19,), torch.float32)
    cuda_build.require(l3boxes, "l3boxes", (m, 8), torch.float32)
    u = units.shape[0]
    cuda_build.require(units, "units", (u, 8, 128), torch.float32)
    cuda_build.require(uaabb, "uaabb", (u, 8), torch.float32)
    for t, name in ((units, "units"), (uaabb, "uaabb")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _same_device((tab, counts, dz, cam, l3boxes, units, uaabb))
    p = tile_px * tile_px
    depth = torch.empty((t_n, p), dtype=torch.float32, device=units.device)
    ids = torch.empty((t_n, p), dtype=torch.int32, device=units.device)
    batch = next(b for b in (4, 2, 1) if c_cap % b == 0)
    fn = cuda_build.function("kaolin_spc_raster_tiles", _RASTER_ARGTYPES)
    with torch.cuda.device(units.device):
        status = fn(cuda_build.ptr(tab), cuda_build.ptr(counts),
                    cuda_build.ptr(dz), cuda_build.ptr(cam),
                    cuda_build.ptr(l3boxes), cuda_build.ptr(units),
                    cuda_build.ptr(uaabb), cuda_build.ptr(depth),
                    cuda_build.ptr(ids), t_n, c_cap,
                    batch, m, tile_px, tx_n, float(width), float(height),
                    cuda_build.stream(units))
    cuda_build.check(status, "kaolin_spc_raster_tiles")
    profiling.count(RASTER_LAUNCHES)
    return depth, ids


def untile_cuda(depth_t, hit_id, *, height, width, tile_px):
    """Tile-packed (T, P) depth and id images → row-major (H·W,), in one
    launch on PyTorch's current stream."""
    ty_n, tx_n = _tiles(height, width, tile_px)
    shape = (ty_n * tx_n, tile_px * tile_px)
    cuda_build.require(depth_t, "depth_t", shape, torch.float32)
    cuda_build.require(hit_id, "hit_id", shape, torch.int32)
    _same_device((depth_t, hit_id))
    depth = torch.empty(height * width, dtype=torch.float32,
                        device=depth_t.device)
    ids = torch.empty(height * width, dtype=torch.int32,
                      device=depth_t.device)
    fn = cuda_build.function("kaolin_spc_untile", _UNTILE_ARGTYPES)
    with torch.cuda.device(depth_t.device):
        status = fn(cuda_build.ptr(depth_t), cuda_build.ptr(hit_id),
                    cuda_build.ptr(depth), cuda_build.ptr(ids), height,
                    width, tile_px, tx_n, cuda_build.stream(depth_t))
    cuda_build.check(status, "kaolin_spc_untile")
    profiling.count(UNTILE_LAUNCHES)
    return depth, ids
