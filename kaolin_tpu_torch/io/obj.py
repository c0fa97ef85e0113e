"""Wavefront OBJ import/export with MTL material support.

Counterpart of ``kaolin_tpu/io/obj.py``: a Python line parser producing a
:class:`~kaolin_tpu_torch.rep.SurfaceMesh` whose tensors (and material
textures) land on ``device``, the CUDA device unless named. Parsing stays
on the host; the textures are read through Pillow.
"""

import os

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import (  # noqa: F401 — handler re-exports
    NonHomogeneousMeshError,
    _host,
    _open_image,
    create_missing_materials_error_handler,
    default_error_handler,
    heterogeneous_mesh_handler_skip,
    ignore_error_handler,
    mesh_handler_naive_triangulate,
    skip_error_handler,
)
from kaolin_tpu_torch.render.materials import PBRMaterial  # noqa: F401
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["import_mesh", "export_mesh", "load_mtl", "raw_material_to_pbr",
           "MaterialError", "MaterialNotFoundError", "MaterialFileError",
           "MaterialLoadError"]


class MaterialError(Exception):
    pass


class MaterialNotFoundError(MaterialError):
    pass


class MaterialFileError(MaterialError):
    pass


class MaterialLoadError(MaterialError):
    pass


def _read_image(path, device):
    """A texture → (3, H, W) float32 in [0, 1], as PIL's ``convert("RGB")``
    / 255."""
    img = np.asarray(_open_image(path).convert("RGB"),
                     dtype=np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(img, (2, 0, 1)))).to(device)


def load_mtl(mtl_path, error_handler=None, device=None):
    """Parse a .mtl file → dict material_name → raw value dict (Kd/Ka/Ks
    as (3,) tensors, map_Kd/map_Ka/map_Ks as CHW tensors, on ``device``)."""
    device = resolve_device(device, "load_mtl")
    error_handler = error_handler or default_error_handler
    materials = {}
    if not os.path.exists(mtl_path):
        error_handler(MaterialFileError(f"cannot open {mtl_path}"))
        return materials
    cur = None
    root = os.path.dirname(mtl_path)
    with open(mtl_path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = {"material_name": parts[1]}
                materials[parts[1]] = cur
            elif cur is None:
                continue
            elif key in ("Kd", "Ka", "Ks"):
                cur[key] = torch.tensor([float(x) for x in parts[1:4]],
                                        dtype=torch.float32, device=device)
            elif key in ("map_Kd", "map_Ka", "map_Ks"):
                try:
                    cur[key] = _read_image(os.path.join(root, parts[-1]),
                                           device)
                except Exception as e:   # the handler decides
                    error_handler(MaterialLoadError(
                        f"failed to load texture {parts[-1]}: {e}"))
    return materials


def raw_material_to_pbr(material):
    """Raw MTL dict → PBRMaterial (metallic workflow; a normal map is
    mapped from [0, 1] to [−1, 1])."""
    supported_maps = {
        "map_kd": "diffuse_texture",
        "map_ks": "specular_texture",
        "bump": "normals_texture",
        "map_bump": "normals_texture",
        "disp": "displacement_texture",
        "map_d": "opacity_texture",
        "map_refl": "metallic_texture",
        "map_ns": "roughness_texture",
    }
    supported_values = {"kd": "diffuse_color", "ks": "specular_color"}
    kwargs = {"is_specular_workflow": False}
    for k, v in material.items():
        if k == "material_name":
            kwargs[k] = v
        elif k.lower() in supported_maps:
            name = supported_maps[k.lower()]
            kwargs[name] = v * 2 - 1.0 if name == "normals_texture" else v
        elif k.lower() in supported_values:
            kwargs[supported_values[k.lower()]] = v
    return PBRMaterial(**kwargs)


def _resolve(idx, n):
    """OBJ indices → 0-based: positive i is i − 1, negative i is n + i, 0
    (absent) is −1."""
    idx = np.asarray(idx, dtype=np.int64)
    return np.where(idx > 0, idx - 1, np.where(idx < 0, idx + n, -1))


def import_mesh(path, with_materials=False, with_normals=False,
                error_handler=None, heterogeneous_mesh_handler=None,
                triangulate=False, raw_materials=True, device=None):
    """Import an OBJ file → unbatched SurfaceMesh on ``device`` (the CUDA
    device unless named). Materials are ordered by sorted name; faces that
    no material is assigned to get −1."""
    device = resolve_device(device, "obj.import_mesh")
    error_handler = error_handler or default_error_handler
    vertices, uvs, normals = [], [], []
    face_v, face_vt, face_vn = [], [], []
    face_counts = []
    mtl_files = []
    material_faces = {}  # name → list of face ids
    cur_material = None
    root = os.path.dirname(path)

    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "f":
                face_counts.append(len(parts) - 1)
                if cur_material is not None:
                    material_faces.setdefault(cur_material, []).append(
                        len(face_counts) - 1)
                for p in parts[1:]:
                    comps = p.split("/")
                    face_v.append(int(comps[0]))
                    face_vt.append(int(comps[1]) if len(comps) > 1
                                   and comps[1] else 0)
                    face_vn.append(int(comps[2]) if len(comps) > 2
                                   and comps[2] else 0)
            elif key == "mtllib":
                mtl_files.append(os.path.join(root, " ".join(parts[1:])))
            elif key == "usemtl":
                cur_material = parts[1]

    vertices = np.asarray(vertices, dtype=np.float32)
    nv, nu, nn = len(vertices), len(uvs), len(normals)
    face_v = _resolve(face_v, nv)
    face_vt = _resolve(face_vt, nu)
    face_vn = _resolve(face_vn, nn)
    counts = np.asarray(face_counts)

    hom = (counts == counts[0]).all() if counts.size else True
    if (not hom) or (triangulate and counts.size and counts[0] != 3):
        handler = heterogeneous_mesh_handler
        if handler is None:
            if not triangulate:
                error_handler(NonHomogeneousMeshError(
                    "faces have varying sizes; set "
                    "heterogeneous_mesh_handler"))
            handler = mesh_handler_naive_triangulate
        assignments = {k: np.asarray(v) for k, v in material_faces.items()}
        out = handler(vertices, counts, face_v, face_vt, face_vn,
                      face_assignments=assignments)
        if out is None:
            return None
        vertices, counts, face_v, face_vt, face_vn, material_faces = out
        if triangulate and counts.size and (counts != 3).any():
            raise NonHomogeneousMeshError("triangulation failed")

    fsz = int(counts[0]) if counts.size else 3
    faces = face_v.reshape(-1, fsz)
    face_uvs_idx = face_vt.reshape(-1, fsz)
    face_normals_idx = face_vn.reshape(-1, fsz)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    kwargs = dict(vertices=t(vertices), faces=t(faces))
    if nu and (face_uvs_idx >= 0).any():
        kwargs["uvs"] = t(np.asarray(uvs, dtype=np.float32))
        kwargs["face_uvs_idx"] = t(face_uvs_idx)
    if with_normals and nn and (face_normals_idx >= 0).any():
        kwargs["normals"] = t(np.asarray(normals, dtype=np.float32))
        kwargs["face_normals_idx"] = t(face_normals_idx)

    materials = None
    if with_materials:
        all_materials = {}
        for m in mtl_files:
            all_materials.update(load_mtl(m, error_handler, device))
        names = sorted(set(material_faces.keys()))
        materials = []
        assignments = np.full((faces.shape[0],), -1, dtype=np.int64)
        for i, name in enumerate(names):
            if name in all_materials:
                mat = all_materials[name]
            else:
                mat = error_handler(MaterialNotFoundError(
                    f"material {name} not found"), material_name=name)
                if mat is None:
                    continue
            materials.append(mat if raw_materials
                             else raw_material_to_pbr(mat))
            assignments[np.asarray(material_faces[name], dtype=np.int64)] = i
        kwargs["material_assignments"] = t(assignments)
    return SurfaceMesh(materials=materials, **kwargs)


def export_mesh(path, vertices=None, faces=None, uvs=None, face_uvs_idx=None,
                normals=None, face_normals_idx=None, mesh=None):
    """Write an OBJ file (vertices, faces, uvs, normals). Numbers are
    written from numpy float32, as their shortest repr."""
    if mesh is not None:
        vertices = mesh.vertices if vertices is None else vertices
        faces = mesh.faces if faces is None else faces
        uvs = mesh.uvs if uvs is None else uvs
        face_uvs_idx = (mesh._attrs.get("face_uvs_idx")
                        if face_uvs_idx is None else face_uvs_idx)
        normals = mesh._attrs.get("normals") if normals is None else normals
        face_normals_idx = (mesh._attrs.get("face_normals_idx")
                            if face_normals_idx is None else face_normals_idx)
    with open(path, "w") as f:
        for v in _host(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if uvs is not None:
            for u in _host(uvs):
                f.write(f"vt {u[0]} {u[1]}\n")
        if normals is not None:
            for n in _host(normals):
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        fuv, fn = _host(face_uvs_idx), _host(face_normals_idx)
        for i, face in enumerate(_host(faces)):
            toks = []
            for k, vi in enumerate(face):
                tok = str(vi + 1)
                if fuv is not None or fn is not None:
                    tok += "/"
                    if fuv is not None and fuv[i][k] >= 0:
                        tok += str(fuv[i][k] + 1)
                    if fn is not None and fn[i][k] >= 0:
                        tok += "/" + str(fn[i][k] + 1)
                toks.append(tok)
            f.write("f " + " ".join(toks) + "\n")


def flatten_feature(feature):
    """Flatten the nested list of a feature."""
    if feature is None or len(feature) == 0:
        return None
    return [item for sublist in feature for item in sublist]


def __getattr__(name):
    # io.materials imports this module's error classes, so a module-level
    # import of it here would be circular
    if name == "process_materials_and_assignments":
        from kaolin_tpu_torch.io.materials import (
            process_materials_and_assignments as fn,
        )
        return fn
    raise AttributeError(name)
