"""CUDA re-gather (``csrc/regather.cu``), the forward and backward of
``rasterization._interpolate_at_winners`` on the card.

It replaces no TPU kernel: the JAX package re-gathers with one
``take_along_axis``, which XLA fuses on the TPU; in the port its plain
version was the DIB-R fit's largest device layer. That plain version is
:func:`.rasterization.interpolate_at_winners_plain`;
``_interpolate_at_winners`` calls these wrappers, through
``rasterization._Regather``, for CUDA tensors and the plain version for CPU
tensors.

The forward's output is the plain version's, bit for bit. In the backward
a missed pixel, and a hit whose output gradient is exactly 0 in every
channel, add nothing: for finite inputs their adds would all be ±0, which
change no sum. The live pixels of a warp that share a face sum their
coordinate gradients before one add; the adds come in no fixed order.

Counters (:mod:`kaolin_tpu_torch.utils.profiling`): the launches of each
(``FWD_LAUNCHES``, ``BWD_LAUNCHES``), and while the profiler runs the
pixels the backward takes and those that added (``PIXELS``).
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, _P] + [_I] * 5 + [_F] * 3 \
    + [_P]
_BWD_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, _P, _P, _P] + [_I] * 5 \
    + [_F] * 3 + [_P, _I, _P]
FWD_LAUNCHES = "render.mesh.regather_fwd.launches"
BWD_LAUNCHES = "render.mesh.regather_bwd.launches"
# the backward's device counters: the pixels it takes, and those that hit
# and whose output gradient is not 0 in every channel, which add
PIXELS = ("render.mesh.regather_bwd.pixels",
          "render.mesh.regather_bwd.pixels_added")
for _name in (FWD_LAUNCHES, BWD_LAUNCHES):
    profiling.count(_name, 0)


def check_inputs(face_idx, scaled, features):
    """Check what both kernels take → the batch stride of ``features`` in
    floats.

    ``face_idx``: (B, H, W) int32; ``scaled``: (B, F, 3, 2) float32;
    ``features``: (B, F, 3, D) float32 whose views are each contiguous (a
    batch expanded from one, stride 0, is read as it is). Type and shape
    are checked on any device, then the device, then the layout."""
    cuda_build.check_tensor(face_idx, "face_idx", 3, torch.int32)
    cuda_build.check_tensor(scaled, "scaled", 4, torch.float32)
    cuda_build.check_tensor(features, "features", 4, torch.float32)
    b, f = scaled.shape[:2]
    if scaled.shape[2:] != (3, 2) or face_idx.shape[0] != b:
        raise ValueError(f"scaled must be ({face_idx.shape[0]}, F, 3, 2), "
                         f"got {tuple(scaled.shape)}")
    if features.shape[:3] != (b, f, 3):
        raise ValueError(f"features must be ({b}, {f}, 3, D), got "
                         f"{tuple(features.shape)}")
    if not face_idx.is_cuda:
        raise ValueError("face_idx must be a CUDA tensor")
    for name, t in (("scaled", scaled), ("features", features)):
        if t.device != face_idx.device:
            raise ValueError(f"{name} must be on {face_idx.device}, got "
                             f"{t.device}")
    if not (face_idx.is_contiguous() and scaled.is_contiguous()):
        raise ValueError("face_idx and scaled must be contiguous")
    if b > 0 and not features[0].is_contiguous():
        raise ValueError("each view of features must be contiguous, got "
                         f"strides {features.stride()}")
    return features.stride(0) if b > 1 else 0


def _scales(face_idx, multiplier):
    """The pixel centres' scales, as ``_pixel_coords`` takes them."""
    height, width = face_idx.shape[1:]
    return multiplier / width, multiplier / height


def regather_fwd_cuda(face_idx, scaled, features, multiplier, eps):
    """The winners' interpolated features (B, H, W, D), 0 at a miss, on the
    card, as ``interpolate_at_winners_plain`` computes them, bit for bit."""
    bstride = check_inputs(face_idx, scaled, features)
    b, height, width = face_idx.shape
    f, d = scaled.shape[1], features.shape[-1]
    out = torch.empty((b, height, width, d), dtype=torch.float32,
                      device=scaled.device)
    fn = cuda_build.function("kaolin_regather_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(scaled.device):
        status = fn(cuda_build.ptr(face_idx), cuda_build.ptr(scaled),
                    cuda_build.ptr(features), bstride, cuda_build.ptr(out),
                    b, f, height, width, d, *_scales(face_idx, multiplier),
                    eps, cuda_build.stream(scaled))
    cuda_build.check(status, "kaolin_regather_fwd")
    profiling.count(FWD_LAUNCHES)
    return out


def regather_bwd_cuda(face_idx, scaled, features, grad_out, multiplier, eps,
                      need_scaled=True, need_features=True):
    """Gradients with respect to ``scaled`` and ``features`` given
    ``grad_out`` (B, H, W, D) → (grad_scaled (B, F, 3, 2) or None,
    grad_features (B, F, 3, D) or None), each None where not asked for.

    ``grad_features`` is a full batch even where ``features`` was expanded
    from one view: autograd's expand sums it. Both are summed by atomics, in
    no fixed order."""
    bstride = check_inputs(face_idx, scaled, features)
    b, height, width = face_idx.shape
    f, d = scaled.shape[1], features.shape[-1]
    cuda_build.require(grad_out, "grad_out", (b, height, width, d),
                       torch.float32)
    if grad_out.device != scaled.device:
        raise ValueError(f"grad_out must be on {scaled.device}, got "
                         f"{grad_out.device}")
    dev = scaled.device
    grad_scaled = (torch.empty((b, f, 3, 2), dtype=torch.float32, device=dev)
                   if need_scaled else None)
    grad_feats = (torch.empty((b, f, 3, d), dtype=torch.float32, device=dev)
                  if need_features else None)
    counters, reset = profiling.device_counters(PIXELS, dev)
    fn = cuda_build.function("kaolin_regather_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(cuda_build.ptr(face_idx), cuda_build.ptr(scaled),
                    cuda_build.ptr(features), bstride,
                    cuda_build.ptr(grad_out),
                    None if grad_scaled is None
                    else cuda_build.ptr(grad_scaled),
                    None if grad_feats is None
                    else cuda_build.ptr(grad_feats),
                    b, f, height, width, d, *_scales(face_idx, multiplier),
                    eps, counters, int(reset), cuda_build.stream(scaled))
    cuda_build.check(status, "kaolin_regather_bwd")
    profiling.count(BWD_LAUNCHES)
    return grad_scaled, grad_feats
