"""glTF 2.0 mesh import (.gltf and .glb) with PBR materials.

Counterpart of ``kaolin_tpu/io/gltf.py``: a parser of the JSON and its
binary buffers with no pygltflib dependency. POSITION, NORMAL and
TEXCOORD_0 attributes, indexed triangles, node hierarchy transforms, the
metallic-roughness and specular-glossiness workflows, transmission, and
textures read by the port's PNG codec. Parsing stays on the host; what the
importers return lands on ``device``, the CUDA device unless named.

:func:`import_mesh` merges the primitives into one mesh with their UVs and
normals where every primitive has them; the JAX package's merge keeps only
vertices, faces and materials (fault F29).
"""

import base64
import json
import os
import struct

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _open_image
from kaolin_tpu_torch.render.materials import PBRMaterial
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["import_mesh", "import_meshes"]

_COMPONENT_TYPES = {
    5120: ("i1", 1), 5121: ("u1", 1), 5122: ("i2", 2), 5123: ("u2", 2),
    5125: ("u4", 4), 5126: ("f4", 4),
}
_NUM_COMPONENTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                   "MAT4": 16}


def _load_gltf(path):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"glTF":
        return json.loads(data), None
    pos = 12                              # GLB: magic, version, length
    gltf, bin_chunk = None, None
    while pos < len(data):
        clen, ctype = struct.unpack("<II", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + clen]
        if ctype == 0x4E4F534A:           # JSON
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:         # BIN
            bin_chunk = chunk
        pos += 8 + clen
    return gltf, bin_chunk


def _load_buffers(gltf, bin_chunk, root):
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(root, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(gltf, buffers, idx):
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dt, isize = _COMPONENT_TYPES[acc["componentType"]]
    ncomp = _NUM_COMPONENTS[acc["type"]]
    count = acc["count"]
    buf = buffers[view.get("buffer", 0)]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", isize * ncomp)
    if stride == isize * ncomp:
        return np.frombuffer(buf, dtype="<" + dt, count=count * ncomp,
                             offset=offset).reshape(count, ncomp)
    # an interleaved buffer view: a strided window over the raw bytes
    raw = np.frombuffer(buf, dtype=np.uint8,
                        count=(count - 1) * stride + isize * ncomp,
                        offset=offset)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(count, isize * ncomp), strides=(stride, 1))
    return np.ascontiguousarray(strided).view("<" + dt).reshape(count, ncomp)


class _Reader:
    """The file's parts that materials read textures from, and the device
    they land on."""

    def __init__(self, gltf, buffers, root, device):
        self.gltf, self.buffers = gltf, buffers
        self.root, self.device = root, device

    def tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def texture(self, tex_idx, with_alpha=False):
        """Texture ``tex_idx`` → (3, H, W) float32 in [0, 1], as PIL's
        ``convert("RGB")`` / 255; with ``with_alpha`` → (rgb, alpha (1, H,
        W)) from ``convert("RGBA")``."""
        gltf = self.gltf
        img = gltf["images"][gltf["textures"][tex_idx]["source"]]
        if "uri" in img:
            uri = img["uri"]
            source = base64.b64decode(uri.split(",", 1)[1]) \
                if uri.startswith("data:") else os.path.join(self.root, uri)
        else:
            view = gltf["bufferViews"][img["bufferView"]]
            buf = self.buffers[view.get("buffer", 0)]
            off = view.get("byteOffset", 0)
            source = bytes(buf[off:off + view["byteLength"]])
        arr = np.asarray(_open_image(source).convert(
            "RGBA" if with_alpha else "RGB"))
        chw = self.tensor(np.transpose(arr, (2, 0, 1)) / np.float32(255.0))
        return (chw[:3], chw[3:4]) if with_alpha else chw


def _specular_glossiness_to_pbr(reader, ext, kwargs):
    """KHR_materials_pbrSpecularGlossiness → specular-workflow fields:
    diffuse from diffuseFactor/Texture, specular RGB from the
    specularGlossiness texture, roughness = 1 − glossiness (its alpha times
    glossinessFactor)."""
    kwargs["is_specular_workflow"] = True
    diffuse_factor = ext.get("diffuseFactor", [1.0, 1.0, 1.0, 1.0])
    if "diffuseTexture" in ext:
        tex = reader.texture(ext["diffuseTexture"]["index"])
        kwargs["diffuse_texture"] = tex * reader.tensor(
            diffuse_factor[:3]).reshape(3, 1, 1)
        kwargs["diffuse_colorspace"] = "srgb"
    else:
        kwargs["diffuse_color"] = reader.tensor(diffuse_factor[:3])
    spec_factor = ext.get("specularFactor", [1.0, 1.0, 1.0])
    gloss_factor = float(ext.get("glossinessFactor", 1.0))
    if "specularGlossinessTexture" in ext:
        spec, gloss = reader.texture(
            ext["specularGlossinessTexture"]["index"], with_alpha=True)
        kwargs["specular_texture"] = spec * reader.tensor(
            spec_factor).reshape(3, 1, 1)
        kwargs["roughness_texture"] = 1.0 - gloss * gloss_factor
    else:
        kwargs["specular_color"] = reader.tensor(spec_factor)
        kwargs["roughness_value"] = reader.tensor(1.0 - gloss_factor)


def _material_to_pbr(reader, mat):
    kwargs = {"material_name": mat.get("name", "")}
    extensions = mat.get("extensions", {})
    # the specular-glossiness extension takes priority when a material
    # carries both workflows
    if "KHR_materials_pbrSpecularGlossiness" in extensions:
        _specular_glossiness_to_pbr(
            reader, extensions["KHR_materials_pbrSpecularGlossiness"], kwargs)
        if "normalTexture" in mat:
            kwargs["normals_texture"] = reader.texture(
                mat["normalTexture"]["index"])
        return PBRMaterial(**kwargs)

    pmr = mat.get("pbrMetallicRoughness", {})
    if "baseColorTexture" in pmr:
        tex = reader.texture(pmr["baseColorTexture"]["index"])
        factor = pmr.get("baseColorFactor", [1.0] * 4)[:3]
        kwargs["diffuse_texture"] = tex * reader.tensor(factor).reshape(
            3, 1, 1)
        kwargs["diffuse_colorspace"] = "srgb"
    elif "baseColorFactor" in pmr:
        kwargs["diffuse_color"] = reader.tensor(pmr["baseColorFactor"][:3])
    if "metallicRoughnessTexture" in pmr:
        mr = reader.texture(pmr["metallicRoughnessTexture"]["index"])
        kwargs["roughness_texture"] = mr[1:2] * float(
            pmr.get("roughnessFactor", 1.0))
        kwargs["metallic_texture"] = mr[2:3] * float(
            pmr.get("metallicFactor", 1.0))
    else:
        if "metallicFactor" in pmr:
            kwargs["metallic_value"] = reader.tensor(pmr["metallicFactor"])
        if "roughnessFactor" in pmr:
            kwargs["roughness_value"] = reader.tensor(pmr["roughnessFactor"])
    if "KHR_materials_transmission" in extensions:
        ext = extensions["KHR_materials_transmission"]
        factor = float(ext.get("transmissionFactor", 0.0))
        if "transmissionTexture" in ext:
            tex = reader.texture(ext["transmissionTexture"]["index"])
            kwargs["transmittance_texture"] = tex[0:1] * factor
        else:
            kwargs["transmittance_value"] = reader.tensor(factor)
    if "normalTexture" in mat:
        kwargs["normals_texture"] = reader.texture(
            mat["normalTexture"]["index"])
    return PBRMaterial(**kwargs)


def _local_transform(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y), 0],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x), 0],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]])
        m = r @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _node_transforms(gltf, scene=None):
    """World 4x4 transform per node (column vectors) → (world, reachable):
    ``reachable`` is the set of nodes in the selected scene's graph (the
    default scene when ``scene`` is None or "default")."""
    nodes = gltf.get("nodes", [])
    world = [None] * len(nodes)

    def visit(i, parent):
        world[i] = parent @ _local_transform(nodes[i])
        for c in nodes[i].get("children", []):
            visit(c, world[i])

    scenes = gltf.get("scenes")
    if scenes is None:
        # no scenes at all: the parentless nodes are the roots
        children = {c for nd in nodes for c in nd.get("children", [])}
        roots = [i for i in range(len(nodes)) if i not in children]
    else:
        scene_idx = (gltf.get("scene", 0) if scene in (None, "default")
                     else int(scene))
        # a scene without nodes renders nothing (glTF spec)
        roots = scenes[scene_idx].get("nodes", [])
    for r in roots:
        visit(r, np.eye(4))
    reachable = {i for i, w in enumerate(world) if w is not None}
    for i in range(len(nodes)):
        if world[i] is None:
            world[i] = _local_transform(nodes[i])
    return world, reachable


def import_meshes(path, scene=None, device=None):
    """Every triangle primitive of the file → list of SurfaceMesh in world
    space, on ``device`` (the CUDA device unless named). ``scene=None``
    imports every mesh whatever its scene; an int (or "default") only those
    reachable from that scene's nodes. Normals go through the inverse of
    the node's linear part; TEXCOORD_0's v is flipped to 1 − v."""
    device = resolve_device(device, "gltf.import_meshes")
    gltf, bin_chunk = _load_gltf(path)
    root = os.path.dirname(path)
    buffers = _load_buffers(gltf, bin_chunk, root)
    reader = _Reader(gltf, buffers, root, device)
    world, reachable = _node_transforms(gltf, scene=scene)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out = []
    for ni, node in enumerate(gltf.get("nodes", [])):
        if "mesh" not in node:
            continue
        if scene is not None and ni not in reachable:
            continue
        for prim in gltf["meshes"][node["mesh"]].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(
                np.float32)
            posh = np.concatenate([pos, np.ones_like(pos[:, :1])], axis=1)
            pos = (posh @ world[ni].T)[:, :3].astype(np.float32)
            if "indices" in prim:
                faces = _read_accessor(gltf, buffers, prim["indices"])
                faces = faces.reshape(-1, 3).astype(np.int64)
            else:
                faces = np.arange(pos.shape[0]).reshape(-1, 3)
            kwargs = dict(vertices=t(pos), faces=t(faces))
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(
                    np.float32)
                nrm = (nrm @ np.linalg.inv(world[ni][:3, :3])).astype(
                    np.float32)
                kwargs["normals"] = t(nrm)
                kwargs["face_normals_idx"] = t(faces)
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, buffers,
                                    attrs["TEXCOORD_0"]).astype(np.float32)
                uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=-1)  # gl y-up
                kwargs["uvs"] = t(uv)
                kwargs["face_uvs_idx"] = t(faces)
            if "material" in prim:
                kwargs["materials"] = [_material_to_pbr(
                    reader, gltf["materials"][prim["material"]])]
                kwargs["material_assignments"] = torch.zeros(
                    faces.shape[0], dtype=torch.int64, device=device)
            out.append(SurfaceMesh(**kwargs))
    return out


def _merge_indexed(meshes, values, index):
    """``values`` of every mesh concatenated, and ``index`` offset by the
    values before it → (values, index); None where some mesh lacks them."""
    if not all(m.has_attribute(values) and m.has_attribute(index)
               for m in meshes):
        return None
    offsets = np.cumsum([0] + [m.get_attribute(values).shape[0]
                               for m in meshes[:-1]])
    return (torch.cat([m.get_attribute(values) for m in meshes]),
            torch.cat([m.get_attribute(index) + int(o)
                       for m, o in zip(meshes, offsets)]))


def import_mesh(path, scene=None, device=None):
    """The primitives of a glTF file merged into one unbatched SurfaceMesh
    on ``device`` (the CUDA device unless named), with the UVs and normals
    where every primitive has them. ``scene`` selects a scene index; the
    default is the file's default scene."""
    meshes = import_meshes(path, scene="default" if scene is None else scene,
                           device=device)
    if not meshes:
        raise ValueError(f"no triangle meshes in {path}")
    if len(meshes) == 1:
        return meshes[0]
    materials, assignments = [], []
    for m in meshes:
        mat_idx = -1
        if m.materials:
            mat_idx = len(materials)
            materials.extend(m.materials)
        assignments.append(torch.full_like(m.faces[:, 0], mat_idx))
    kwargs = {}
    for values, index in (("uvs", "face_uvs_idx"),
                          ("normals", "face_normals_idx")):
        merged = _merge_indexed(meshes, values, index)
        if merged is not None:
            kwargs[values], kwargs[index] = merged
    verts, faces = _merge_indexed(meshes, "vertices", "faces")
    if materials:
        kwargs["materials"] = materials
        kwargs["material_assignments"] = torch.cat(assignments)
    return SurfaceMesh(vertices=verts, faces=faces, **kwargs)
