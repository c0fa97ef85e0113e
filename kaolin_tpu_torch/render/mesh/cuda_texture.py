"""CUDA texture sampling (``csrc/texture.cu``), the forward and backward of
:func:`kaolin_tpu_torch.render.mesh.utils.texture_mapping`.

It replaces no TPU kernel: the JAX package samples with four plain
gathers, which XLA fuses on the TPU; in the port they were the DIB-R fit's
largest device time. Its plain PyTorch version is
:func:`kaolin_tpu_torch.render.mesh.utils.texture_mapping_plain`;
``texture_mapping`` calls these wrappers, through ``utils._TextureMapping``,
for CUDA tensors and the plain version for CPU tensors.

Bound at the DIB-R fit's shapes (8 x 512² UVs, 3 channels; an H100's 3.35
TB/s): 31 µs a forward and backward with a 3 x 256² texture, 41 µs with a
3 x 1,024² one, counting each byte read or written once. The backward is
held by its atomics rather than its bytes. A pixel whose output gradient is
exactly 0 in every channel adds nothing and gets a UV gradient of 0: for
finite UVs and texture its adds would all be ±0, which change no sum.

Counters (:mod:`kaolin_tpu_torch.utils.profiling`): the launches of each
(``FWD_LAUNCHES``, ``BWD_LAUNCHES``), and while the profiler runs the
pixels the backward takes and those that added to the texture
(``PIXELS``).
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD_ARGTYPES = [_P, _I, _P, _L, _P] + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P, _I, _P, _L, _P, _P, _P, _L, _L] + [_I] * 6 \
    + [_P, _I, _P]
MODES = ("bilinear", "nearest")
FWD_LAUNCHES = "render.mesh.texture_fwd.launches"
BWD_LAUNCHES = "render.mesh.texture_bwd.launches"
# the backward's device counters: the pixels it takes, and those whose
# output gradient is not 0 in every channel, which add to the texture
PIXELS = ("render.mesh.texture_bwd.pixels",
          "render.mesh.texture_bwd.pixels_added")
for _name in (FWD_LAUNCHES, BWD_LAUNCHES):
    profiling.count(_name, 0)


def pair_stride(uv):
    """The stride in floats between the (B, N, 2) ``uv``'s pairs where
    they are contiguous and evenly spaced across views and pixels, as the
    kernels read them (a slice of a contiguous feature image is), else
    None."""
    b, n = uv.shape[:2]
    stride = uv.stride(1) if n > 1 else uv.stride(0) if b > 1 else 2
    if uv.stride(2) != 1 or (b > 1 and n > 1 and uv.stride(0) != n * stride):
        return None
    return stride


def check_inputs(uv, texture, mode):
    """Check what both kernels take → (pixel stride of ``uv``, batch stride
    of ``texture``).

    ``uv``: (B, N, 2) float32 pairs as :func:`pair_stride` takes them.
    ``texture``: (1 or B, C, H', W') float32 on ``uv``'s device with
    contiguous channel planes; a batch of 1, or a batch stride of 0, is one
    texture that every view samples. Type and shape are checked on any
    device, then the device, then the layout."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cuda_build.check_tensor(uv, "uv", 3, torch.float32)
    cuda_build.check_tensor(texture, "texture", 4, torch.float32)
    b, n = uv.shape[:2]
    bt, c, h, w = texture.shape
    if uv.shape[2] != 2:
        raise ValueError(f"uv must be (B, N, 2), got {tuple(uv.shape)}")
    if bt not in (1, b) or min(c, h, w) <= 0:
        raise ValueError(f"texture must be (1 or {b}, C, H', W') with C, "
                         f"H', W' > 0, got {tuple(texture.shape)}")
    if not uv.is_cuda:
        raise ValueError("uv must be a CUDA tensor")
    if texture.device != uv.device:
        raise ValueError(f"texture must be on {uv.device}, got "
                         f"{texture.device}")
    stride = pair_stride(uv)
    if stride is None:
        raise ValueError("uv's pairs must be contiguous and evenly spaced "
                         f"across views, got strides {uv.stride()}")
    if not texture[0].is_contiguous():
        raise ValueError("texture's channel planes must be contiguous, got "
                         f"strides {texture.stride()}")
    return stride, texture.stride(0) if bt > 1 else 0


def texture_fwd_cuda(uv, texture, mode):
    """Samples (B, N, C) of ``texture`` at ``uv`` on the card, as
    ``texture_mapping_plain`` computes them, bit for bit."""
    uv_stride, tex_bstride = check_inputs(uv, texture, mode)
    b, n = uv.shape[:2]
    _, c, h, w = texture.shape
    out = torch.empty((b, n, c), dtype=torch.float32, device=uv.device)
    fn = cuda_build.function("kaolin_texture_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(uv.device):
        status = fn(cuda_build.ptr(uv), uv_stride, cuda_build.ptr(texture),
                    tex_bstride, cuda_build.ptr(out), b, n, c, h, w,
                    int(mode == "bilinear"), cuda_build.stream(uv))
    cuda_build.check(status, "kaolin_texture_fwd")
    profiling.count(FWD_LAUNCHES)
    return out


def texture_bwd_cuda(uv, texture, grad_out, mode, need_uv=True,
                     need_texture=True):
    """Gradients with respect to ``uv`` and ``texture`` given ``grad_out``
    (B, N, C) → (grad_uv (B, N, 2) or None, grad_texture of
    ``texture``'s shape or None).

    ``grad_uv`` is None in "nearest" mode, where the UVs only choose
    texels, and where ``need_uv`` is false; ``grad_texture`` where
    ``need_texture`` is. A texture of batch 1 gets one gradient, the sum
    over every view. The texture's gradient is summed by atomics, in no
    fixed order."""
    uv_stride, tex_bstride = check_inputs(uv, texture, mode)
    b, n = uv.shape[:2]
    bt, c, h, w = texture.shape
    cuda_build.require(grad_out, "grad_out", (b, n, c), torch.float32)
    if grad_out.device != uv.device:
        raise ValueError(f"grad_out must be on {uv.device}, got "
                         f"{grad_out.device}")
    bilinear = mode == "bilinear"
    grad_uv = (torch.empty((b, n, 2), dtype=torch.float32, device=uv.device)
               if need_uv and bilinear else None)
    grad_tex = (torch.empty((bt, c, h, w), dtype=torch.float32,
                            device=uv.device) if need_texture else None)
    counters, reset = profiling.device_counters(PIXELS, uv.device)
    fn = cuda_build.function("kaolin_texture_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(uv.device):
        status = fn(cuda_build.ptr(uv), uv_stride, cuda_build.ptr(texture),
                    tex_bstride, cuda_build.ptr(grad_out),
                    None if grad_uv is None else cuda_build.ptr(grad_uv),
                    None if grad_tex is None else cuda_build.ptr(grad_tex),
                    c * h * w if bt > 1 else 0, bt * c * h * w, b, n, c, h,
                    w, int(bilinear), counters, int(reset),
                    cuda_build.stream(uv))
    cuda_build.check(status, "kaolin_texture_bwd")
    profiling.count(BWD_LAUNCHES)
    return grad_uv, grad_tex
