"""Render helpers: texture sampling, SH lighting, vertex preparation.

Counterpart of ``kaolin_tpu/render/mesh/utils.py``. ``texture_mapping``
samples as ``grid_sample(align_corners=False, padding_mode='border')``
does. On a CUDA tensor it runs the hand-written kernel pair of
:mod:`.cuda_texture` (``csrc/texture.cu``), which replaces no TPU kernel:
the JAX package samples with four plain gathers, and in the port those
gathers and their scatter-add backward were the DIB-R fit's largest device
time, at about 0.5% of their bytes bound (31 and 41 µs a step at the fit's
8 x 512² UVs with a 3 x 256² and a 3 x 1,024² texture on an H100).
On a CPU tensor it runs the plain version :func:`texture_mapping_plain`:
four gathers, with the bilinear weights written as the JAX package writes
them (not ``F.grid_sample``), so the weights round as there, and the kernel
rounds the samples as the plain version does, bit for bit. Both split the
UV clip's gradient at 0 and 1 as ``jnp.clip`` does. The kernel's backward
skips a pixel whose output gradient is exactly 0 in every channel: for
finite UVs and texture its adds would all be ±0, which change no sum.

A texture batch with stride 0, one texture expanded to every view, is read
as that one texture (:func:`_one_texture`), so that its gradient is
summed once over the views, into one (C, H', W') tensor, and not through
``expand``'s backward. Its spans (:mod:`kaolin_tpu_torch.utils.profiling`,
while the profiler runs) are ``render.mesh.texture_mapping`` and its
``.backward``.
"""

import torch
from torch.autograd.function import once_differentiable

from kaolin_tpu_torch.ops.mesh import face_normals as compute_face_normals
from kaolin_tpu_torch.ops.mesh import index_vertices_by_faces
from kaolin_tpu_torch.render.camera.legacy import (
    perspective_camera,
    rotate_translate_points,
)
from kaolin_tpu_torch.render.mesh import cuda_texture
from kaolin_tpu_torch.utils import profiling
from kaolin_tpu_torch.utils.backend import is_cuda
from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["texture_mapping", "texture_mapping_plain",
           "spherical_harmonic_lighting", "prepare_vertices"]


def _gather(flat, yi, xi, width):
    """flat (B, C, H·W), pixel rows and columns (B, N) → (B, C, N)."""
    idx = (yi.long() * width + xi.long())[:, None, :]
    return torch.gather(flat, 2, idx.expand(-1, flat.shape[1], -1))


def _grid_sample_2d(image, coords, mode="bilinear"):
    """image (B, C, Hin, Win); coords (B, N, 2) in [-1, 1], x then y;
    border padding, align_corners=False → (B, N, C)."""
    b, c, h, w = image.shape
    flat = image.reshape(b, c, h * w)
    x = (coords[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (coords[..., 1] + 1.0) * (h / 2.0) - 0.5
    if mode == "nearest":
        xi = torch.clamp(torch.round(x).to(torch.int32), 0, w - 1)
        yi = torch.clamp(torch.round(y).to(torch.int32), 0, h - 1)
        return _gather(flat, yi, xi, w).transpose(1, 2)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
    x1i = torch.clamp(x0.to(torch.int32) + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0.to(torch.int32) + 1, 0, h - 1)
    v00 = _gather(flat, y0i, x0i, w)
    v01 = _gather(flat, y0i, x1i, w)
    v10 = _gather(flat, y1i, x0i, w)
    v11 = _gather(flat, y1i, x1i, w)
    out = (v00 * (1 - tx) * (1 - ty) + v01 * tx * (1 - ty)
           + v10 * (1 - tx) * ty + v11 * tx * ty)
    return out.transpose(1, 2)


def texture_mapping_plain(uv, texture, mode="nearest"):
    """The plain version of the texture kernels: UVs (B, N, 2), a texture
    (1 or B, C, H', W') → samples (B, N, C), differentiable by autograd."""
    tc = clip(uv, 0.0, 1.0) * 2.0 - 1.0
    tc = tc * tc.new_tensor([1.0, -1.0])     # y up → image rows down
    return _grid_sample_2d(texture.expand(uv.shape[0], -1, -1, -1), tc, mode)


class _TextureMapping(torch.autograd.Function):
    """Samples (B, N, C) of a texture (1 or B, C, H', W') at UVs (B, N, 2)
    on the card: the forward and backward kernels of :mod:`.cuda_texture`.
    The gradient of a texture of batch 1 is one (1, C, H', W') tensor, the
    sum over every view. The backward kernel's gradients are not
    differentiable: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, uv, texture, mode):
        ctx.save_for_backward(uv, texture)
        ctx.mode = mode
        return cuda_texture.texture_fwd_cuda(uv, texture, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        uv, texture = ctx.saved_tensors
        grad_uv, grad_tex = cuda_texture.texture_bwd_cuda(
            uv, texture, grad_out.contiguous(), ctx.mode,
            *ctx.needs_input_grad[:2])
        return grad_uv, grad_tex, None


def _one_texture(texture_maps):
    """The tensor that a texture batch with stride 0 was expanded from,
    where it holds exactly the one texture every view reads (so that
    ``base.view(1, C, H', W')`` is it) and a gradient of the batch reaches
    it through the views' own backward, else None. Reading that tensor in
    place of the expand sums the views' gradients once, in the layer,
    instead of in ``expand``'s backward over a (B, C, H', W') gradient.

    Refused: a batch whose gradient would not reach the base (views made
    under ``no_grad``, or a batch that requires grad of a base that does
    not), and a base of another dtype, size or layout."""
    if texture_maps.shape[0] < 2 or texture_maps.stride(0) != 0:
        return None
    base, first = texture_maps._base, texture_maps[:1]
    if base is None or base.dtype != texture_maps.dtype \
            or base.requires_grad != texture_maps.requires_grad \
            or (texture_maps.requires_grad and texture_maps.grad_fn is None) \
            or base.numel() != first.numel() or not base.is_contiguous() \
            or not first.is_contiguous() \
            or base.data_ptr() != first.data_ptr():
        return None
    return base


def texture_mapping(texture_coordinates, texture_maps, mode="nearest"):
    """Sample texture maps at OpenGL-style (y up, [0, 1]) UV coords.

    texture_coordinates: (B, H, W, 2) or (B, N, 2); texture_maps:
    (B, C, H', W'). Returns (B, H, W, C) or (B, N, C). Differentiable with
    respect to the texture and, in "bilinear" mode, the UVs; at a UV of
    exactly 0 or 1 the clip passes half the gradient, as in JAX.

    CUDA tensors go through the texture kernels, which take float32 and
    raise on anything else; CPU tensors through
    :func:`texture_mapping_plain`. A batch of one texture expanded to every
    view (stride 0) is read as that texture on either device."""
    with profiling.span("render.mesh.texture_mapping"):
        batch_size = texture_coordinates.shape[0]
        num_channels = texture_maps.shape[1]
        uv = texture_coordinates.reshape(batch_size, -1, 2)
        base = _one_texture(texture_maps)
        texture = (texture_maps if base is None
                   else base.view(1, *texture_maps.shape[1:]))
        if is_cuda(uv):
            if cuda_texture.pair_stride(uv) is None:
                uv = uv.contiguous()
            if not texture[0].is_contiguous():
                texture = texture.contiguous()
            out = _TextureMapping.apply(uv, texture, mode)
        else:
            out = texture_mapping_plain(uv, texture, mode)
        out = out.reshape(batch_size, *texture_coordinates.shape[1:-1],
                          num_channels)
        profiling.backward_span("render.mesh.texture_mapping",
                                (texture_coordinates, texture_maps, base),
                                out)
    return out


def spherical_harmonic_lighting(imnormal, lights):
    """SH9 lighting from per-pixel normals (B, H, W, 3) and SH params
    (B, 9) → (B, H, W)."""
    x = imnormal[..., 0]
    y = imnormal[..., 1]
    z = imnormal[..., 2]
    bands = torch.stack([
        0.28209479177 * torch.ones_like(x),
        0.4886025119 * x,
        0.4886025119 * z,
        0.4886025119 * y,
        1.09254843059 * (x * y),
        1.09254843059 * (y * z),
        0.94617469575 * (z * z) - 0.31539156525,
        0.77254840404 * (x * z),
        0.38627420202 * (x * x - y * y),
    ], dim=-1)
    return torch.sum(bands * lights.reshape(-1, 1, 1, 9), dim=-1)


def prepare_vertices(vertices, faces, camera_proj, camera_rot=None,
                     camera_trans=None, camera_transform=None):
    """Move vertices (B, V, 3) into camera space, project them, index them
    by faces and compute the faces' unit normals → (face_vertices_camera
    (B, F, 3, 3), face_vertices_image (B, F, 3, 2), face_normals
    (B, F, 3)). The camera is either ``camera_rot`` and ``camera_trans``
    (P_cam = R (P − T)) or ``camera_transform`` (B, 4, 3) (P_cam = [P, 1] @
    M, as :func:`~kaolin_tpu_torch.render.camera.legacy.
    generate_transformation_matrix` makes it)."""
    if camera_transform is None:
        assert camera_rot is not None and camera_trans is not None
        vertices_camera = rotate_translate_points(vertices, camera_rot,
                                                  camera_trans)
    else:
        assert camera_rot is None and camera_trans is None
        padded = torch.cat([vertices, torch.ones_like(vertices[..., :1])],
                           dim=-1)
        vertices_camera = padded @ camera_transform
    vertices_image = perspective_camera(vertices_camera, camera_proj)
    face_vertices_camera = index_vertices_by_faces(vertices_camera, faces)
    face_vertices_image = index_vertices_by_faces(vertices_image, faces)
    face_normals = compute_face_normals(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, face_normals
