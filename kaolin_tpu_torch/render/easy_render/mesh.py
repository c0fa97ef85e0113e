"""High-level differentiable mesh rendering: camera → rasterize → texture →
SG shade.

Counterpart of ``kaolin_tpu/render/easy_render/mesh.py``. The rasterizer
is :func:`kaolin_tpu_torch.render.mesh.rasterize`: on a CUDA tensor its
winner search is the hand-written kernel, on a CPU tensor its plain
version. Uncovered pixels are handled by masked whole-image math
(``torch.where`` over (B, H, W)), never boolean indexing, so every pass
has the image's shape. Materials and lights are moved to the mesh's device
when a render reads them.
"""

import enum

import torch

from kaolin_tpu_torch.ops.mesh import face_normals as compute_face_normals
from kaolin_tpu_torch.ops.mesh import index_vertices_by_faces
from kaolin_tpu_torch.render.camera.raygen import (
    generate_centered_custom_resolution_pixel_coords,
    generate_pinhole_rays,
)
from kaolin_tpu_torch.render.easy_render.common import (
    default_lighting,
    default_material,
)
from kaolin_tpu_torch.render.lighting import (
    sg_diffuse_inner_product,
    sg_warp_specular_term,
)
from kaolin_tpu_torch.render.mesh.rasterization import rasterize
from kaolin_tpu_torch.render.mesh.utils import texture_mapping
from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["RenderPass", "render_mesh", "mesh_rasterize_interpolate"]


class RenderPass(str, enum.Enum):
    """The passes ``render_mesh`` returns."""
    face_idx = "face_idx"
    uvs = "uvs"
    albedo = "albedo"
    normals = "normals"
    roughness = "roughness"
    diffuse = "diffuse"
    specular = "specular"
    features = "features"
    render = "render"
    alpha = "alpha"


def _batched(x):
    return x[None] if x.ndim == 3 else x


def _unit(x):
    return x / clip(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def mesh_rasterize_interpolate(mesh, camera, normals_required=True,
                               uvs_required=True, tangents_required=True,
                               features_required=True):
    """Rasterize + interpolate available mesh attributes →
    (face_idx, im_normals, im_tangents, im_uvs, im_features)."""
    vertices = mesh.vertices
    vertices_camera = camera.extrinsics.transform(
        vertices[None] if vertices.ndim == 2 else vertices)
    vertices_image = camera.intrinsics.transform(vertices_camera)
    face_vertices_camera = index_vertices_by_faces(vertices_camera,
                                                   mesh.faces)
    face_vertices_image = index_vertices_by_faces(vertices_image,
                                                  mesh.faces)[..., :2]

    feats = []
    idx_normals = idx_uvs = idx_tangents = idx_features = -1
    cur = 0
    if normals_required and mesh.has_or_can_compute_attribute("face_normals"):
        feats.append(_batched(mesh.face_normals))
        idx_normals = cur
        cur += 3
    if uvs_required and mesh.has_or_can_compute_attribute("face_uvs"):
        feats.append(_batched(mesh.face_uvs))
        idx_uvs = cur
        cur += 2
    if tangents_required and mesh.has_or_can_compute_attribute(
            "face_tangents"):
        feats.append(_batched(mesh.face_tangents))
        idx_tangents = cur
        cur += 3
    if features_required and mesh.has_or_can_compute_attribute(
            "face_features"):
        ff = _batched(mesh.face_features)
        feats.append(ff)
        idx_features = cur
        cur += ff.shape[-1]
    if not feats:
        feats = [face_vertices_camera.new_zeros(
            face_vertices_camera.shape[:-1] + (1,))]
    in_face_features = torch.cat(feats, dim=-1)

    face_features, face_idx = rasterize(
        camera.height, camera.width,
        face_vertices_z=face_vertices_camera[..., -1],
        face_vertices_image=face_vertices_image,
        face_features=in_face_features)

    im_normals = im_uvs = im_tangents = im_features = None
    if idx_normals >= 0:
        im_normals = face_features[..., idx_normals:idx_normals + 3]
    if idx_uvs >= 0:
        im_uvs = torch.remainder(face_features[..., idx_uvs:idx_uvs + 2],
                                 1.0)
    if idx_tangents >= 0:
        im_tangents = face_features[..., idx_tangents:idx_tangents + 3]
    if idx_features >= 0:
        im_features = face_features[..., idx_features:]
    return face_idx, im_normals, im_tangents, im_uvs, im_features


def texture_sample_materials(face_idx, im_base_normals, materials=None,
                             uv_map=None, material_assignments=None,
                             im_tangents=None):
    """Sample per-material textures/values into image-space maps
    (albedo, spec_albedo, world normals, roughness), blending each
    material in where its mask holds."""
    b, height, width = face_idx.shape
    device = face_idx.device
    if materials is None or len(materials) == 0:
        materials = [default_material(device=device)]
    if material_assignments is not None:
        ma = material_assignments.to(device)
        safe = face_idx.clamp(0, ma.shape[0] - 1).long().reshape(-1)
        im_material_idx = torch.where(
            face_idx >= 0, ma[safe].reshape(face_idx.shape).to(torch.int32),
            -1)
    else:
        im_material_idx = torch.where(face_idx >= 0, 0, -1)

    shape = (b, height, width)
    albedo = torch.zeros(shape + (3,), device=device)
    spec_albedo = torch.zeros(shape + (3,), device=device)
    im_roughness = torch.full(shape + (1,), 0.5, device=device)
    im_world_normals = (im_base_normals if im_base_normals is not None
                        else torch.zeros(shape + (3,), device=device))

    im_bitangents = None
    if im_tangents is not None and im_base_normals is not None:
        im_bitangents = _unit(torch.linalg.cross(im_tangents,
                                                 im_base_normals, dim=-1))

    def on_device(x):
        return None if x is None else x.to(device)

    def tex_sample(tex):
        if tex is None or uv_map is None:
            return None
        return texture_mapping(uv_map, tex[None].to(device, torch.float32),
                               mode="bilinear")

    for i, mat in enumerate(materials):
        mask = (im_material_idx == i)[..., None]

        mapped_normal = tex_sample(mat.normals_texture)
        mapped_albedo = tex_sample(mat.diffuse_texture)
        mapped_spec = tex_sample(mat.specular_texture)
        mapped_metallic = tex_sample(mat.metallic_texture)
        mapped_roughness = tex_sample(mat.roughness_texture)

        # shading normals with normal-map perturbation
        if (mapped_normal is not None and im_tangents is not None
                and im_bitangents is not None):
            sn = (im_tangents * mapped_normal[..., :1]
                  - im_bitangents * mapped_normal[..., 1:2]
                  + im_base_normals * mapped_normal[..., 2:3])
            im_world_normals = torch.where(mask, _unit(sn), im_world_normals)

        # albedo
        cur_albedo = None
        if mapped_albedo is not None:
            cur_albedo = mapped_albedo[..., :3]
        elif mat.diffuse_color is not None:
            cur_albedo = on_device(mat.diffuse_color).expand(shape + (3,))
        if cur_albedo is not None:
            albedo = torch.where(mask, cur_albedo, albedo)

        # specular vs metallic workflow
        if mat.is_specular_workflow:
            cur_spec = None
            if mapped_spec is not None:
                cur_spec = mapped_spec
            elif mat.specular_color is not None:
                cur_spec = on_device(mat.specular_color).expand(shape + (3,))
            if cur_spec is not None:
                spec_albedo = torch.where(mask, cur_spec, spec_albedo)
        else:
            m = (mapped_metallic if mapped_metallic is not None
                 else on_device(mat.metallic_value))
            if m is not None:
                spec_albedo = torch.where(
                    mask, (1.0 - m) * 0.04 + albedo * m, spec_albedo)
                albedo = torch.where(mask, albedo * (1.0 - m), albedo)

        min_roughness = 1e-3
        cur_rough = None
        if mapped_roughness is not None:
            cur_rough = clip(mapped_roughness, min_roughness)
        elif mat.roughness_value is not None:
            cur_rough = clip(on_device(mat.roughness_value),
                             min_roughness).expand(shape + (1,))
        if cur_rough is not None:
            im_roughness = torch.where(mask, cur_rough, im_roughness)

    return albedo, spec_albedo, im_world_normals, im_roughness


def sg_shade(camera, face_idx, albedo, spec_albedo, im_roughness,
             im_world_normals, amplitude, direction, sharpness):
    """Diffuse + Cook-Torrance specular under SG lights → (diffuse,
    specular, render), each (B, H, W, 3), 0 at uncovered pixels."""
    b, height, width = face_idx.shape
    hard_mask = (face_idx >= 0).reshape(-1)

    normals = _unit(im_world_normals.reshape(-1, 3))
    alb = albedo.reshape(-1, 3)
    spec = spec_albedo.reshape(-1, 3)
    rough = im_roughness.reshape(-1)

    diffuse = sg_diffuse_inner_product(amplitude, direction, sharpness,
                                       normals, alb)
    pixel_grid = generate_centered_custom_resolution_pixel_coords(
        camera.width, camera.height, width, height, device=face_idx.device)
    # the view rays by lens type: an ortho camera's are its forward axis
    if camera.lens_type == "pinhole":
        _, rays_d = generate_pinhole_rays(camera, pixel_grid)
    else:
        _, rays_d = camera.generate_rays(pixel_grid)
    specular = sg_warp_specular_term(
        amplitude, direction, sharpness, normals, rough,
        -rays_d.reshape(-1, 3), spec)

    mask = hard_mask[:, None]
    diffuse = torch.where(mask, diffuse, 0.0).reshape(b, height, width, 3)
    specular = torch.where(mask, specular, 0.0).reshape(b, height, width, 3)
    return diffuse, specular, diffuse + specular


def render_mesh(camera, mesh, lighting=None, custom_materials=None,
                custom_material_assignments=None, backend=None,
                nvdiffrast_context=None):
    """Render a mesh with materials + SG lighting → dict of render passes
    (always contains 'render'). ``backend`` and ``nvdiffrast_context`` are
    taken for the reference's signature; every device has one rasterizer.
    The light (``default_lighting()`` when None) is read on the mesh's
    device."""
    assert len(camera) == 1, "render_mesh supports a single camera"
    materials = custom_materials or mesh.materials
    assignments = (custom_material_assignments
                   if custom_material_assignments is not None
                   else mesh.material_assignments)
    device = mesh.vertices.device
    if lighting is None:
        lighting = default_lighting(device=device)

    face_idx, im_normals, im_tangents, uv_map, im_features = \
        mesh_rasterize_interpolate(mesh, camera)

    if im_normals is not None:
        # orient normals toward the camera by the NDC face normal's sign
        verts = mesh.vertices
        verts = verts[None] if verts.ndim == 2 else verts
        # the sign's derivative is 0: taken without autograd, its backward
        # (a colliding scatter of every pixel into its face) is not run
        with torch.no_grad():
            fv_ndc = index_vertices_by_faces(camera.transform(verts),
                                             mesh.faces)
            sign = torch.sign(compute_face_normals(fv_ndc)[..., 2])
        safe = face_idx.clamp(min=0).long().reshape(-1)
        im_sign = torch.where(face_idx >= 0,
                              sign[0][safe].reshape(face_idx.shape), 0.0)
        im_normals = im_normals * im_sign[..., None]

    albedo, spec_albedo, im_world_normals, im_roughness = \
        texture_sample_materials(face_idx, im_normals, materials,
                                 uv_map=uv_map,
                                 material_assignments=assignments,
                                 im_tangents=im_tangents)
    diffuse_img, specular_img, img = sg_shade(
        camera, face_idx, albedo, spec_albedo, im_roughness,
        im_world_normals, lighting.amplitude.to(device),
        lighting.direction.to(device), lighting.sharpness.to(device))

    res = {
        RenderPass.face_idx.name: face_idx,
        RenderPass.render.name: img,
        RenderPass.albedo.name: albedo,
        RenderPass.normals.name: im_world_normals,
        RenderPass.roughness.name: im_roughness,
        RenderPass.diffuse.name: diffuse_img,
        RenderPass.specular.name: specular_img,
        RenderPass.uvs.name: uv_map,
        RenderPass.features.name: im_features,
        RenderPass.alpha.name: (face_idx >= 0).float()[..., None],
    }
    return {k: v for k, v in res.items() if v is not None}


# one rasterizer on every device; the reference exports one per backend
mesh_rasterize_interpolate_cuda = mesh_rasterize_interpolate
mesh_rasterize_interpolate_nvdiffrast = mesh_rasterize_interpolate
