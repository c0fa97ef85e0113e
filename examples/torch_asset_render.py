"""An asset written to disk and imported from it with kaolin_tpu_torch.io:
the full render of a textured 81,408-face mesh from OBJ/MTL and from GLB,
binary PLY and OFF imports, a 2^20-gaussian INRIA 3DGS scene through the
PLY reader and writer, a ShapeNetV2 tree through ``CachedDataset`` with
spawned workers, and ``GraphConv`` on the asset's vertex graph.

- **The asset** (:func:`write_asset`). ``torch_easy_render.py``'s 160 x 256
  UV sphere (81,408 faces, its faces sorted so that material 0's come
  first) with its two materials and its textures at 1,024², written four
  ways into a directory:

  - OBJ + MTL + PNG: ``mtllib``, two ``usemtl`` groups, ``v``, ``vt`` (the
    distinct UVs), ``vn`` (the vertex normals) and ``f v/vt/vn`` lines; the
    MTL with ``newmtl``, ``Kd``, ``Ks``, ``map_Kd`` and ``map_Ks`` (the
    keys the reader takes); the maps written by ``io.utils.write_image``.
  - GLB: two nodes under two TRS transforms, one primitive each (material
    0's faces, material 1's), ``uint32`` indices, ``NORMAL`` and
    ``TEXCOORD_0``, the vertices split where a vertex has several UVs;
    material 0 metallic-roughness with base-colour, metallic-roughness and
    normal textures, material 1 ``KHR_materials_pbrSpecularGlossiness``
    with an RGBA specular-glossiness texture; the PNGs in the BIN chunk.
  - Binary PLY with vertex colours, and OFF: the geometry alone.

- **Import** (:func:`import_asset`): ``io.import_mesh`` of each file, the
  OBJ ``with_materials=True, raw_materials=False``.
- **Render** (:func:`render_asset`): ``render_mesh(default_camera(512),
  mesh, default_lighting())`` of the OBJ and GLB imports; a CUDA render
  launches the winner-search kernel once.
- **3DGS** (:func:`gaussian_scene`): 2^20 seeded gaussians at SH degree 3
  exported by ``ply.export_gaussiancloud``, imported by
  ``io.import_gaussiancloud``, rotated and scaled by
  ``transform_gaussians`` (which turns the SH by ``transform_shs``),
  exported and imported again.
- **Dataset** (:func:`dataset`): 64 deformed level-3 icospheres in two
  synsets as a ShapeNetV2 tree, ``CachedDataset`` over ``ShapeNetV2`` with
  :class:`SurfaceSamples` (2,048 points a model, drawn from a generator
  seeded by the item's index) on 4 spawned workers, the items stacked on
  the device.
- **GraphConv** (:func:`graph_conv`): the asset's vertex adjacency as a
  COO tuple, ``GraphConv`` 3 → 256 → 256 → 3 with ``normalize_adj=True``
  at B = 4, forward and backward.

Everything lands on the CUDA device unless ``cpu`` is named; ``smoke`` runs
every part at a small size:

    PYTHONPATH=. python examples/torch_asset_render.py [cuda|cpu] [smoke]
"""

import functools
import importlib.util
import json
import os
import struct
import sys
import tempfile

import numpy as np
import torch

from kaolin_tpu_torch import io as kio
from kaolin_tpu_torch.ops.gaussians import transform_gaussians
from kaolin_tpu_torch.ops.gcn import GraphConv
from kaolin_tpu_torch.ops.mesh import sample_points
from kaolin_tpu_torch.render.materials import PBRMaterial
from kaolin_tpu_torch.rep import GaussianSplatModel, SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

ASSET = (160, 256)            # 81,408 faces
TEX = 1024                    # a real asset's maps
RES = 512
GAUSSIANS = 1 << 20
SH_DEGREE = 3
MODELS = 64                   # in two synsets
SYNSETS = ("02691156", "03001627")
ICO_LEVEL = 3
SAMPLES = 2048
WORKERS = 4
GCN_WIDTHS = (3, 256, 256, 3)
GCN_BATCH = 4
SMOKE = dict(asset=(24, 32), tex=64, res=64, gaussians=4096, models=8,
             samples=256)
# the MTL's colours: material 0 (checker) and 1 (metal)
KD = ((1.0, 1.0, 1.0), (0.75, 0.6, 0.35))
KS = ((0.2, 0.2, 0.2), (0.9, 0.8, 0.6))
# (translation, rotation axis, angle, uniform scale) of the two GLB nodes
NODE_TRS = (((0.1, -0.05, 0.2), (1.0, 1.0, 0.0), 0.5, 1.25),
            ((-0.2, 0.1, 0.0), (0.0, 0.3, 1.0), -0.8, 0.8))
# the 3DGS transform: a rotation about (1, 2, 3) by 0.7 and a scale of 1.5
GS_ROTATION = ((1.0, 2.0, 3.0), 0.7)
GS_SCALE = 1.5


@functools.cache
def _sibling(name):
    """``examples/<name>.py`` as a module, loaded once a process."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quaternion(axis, angle):
    """Unit quaternion (x, y, z, w) of a rotation by ``angle`` about
    ``axis``."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    return np.concatenate([a * np.sin(angle / 2), [np.cos(angle / 2)]])


def _rotation(axis, angle):
    x, y, z, w = _quaternion(axis, angle)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _to8(x):
    """[0, 1] floats as the writer stores them: clipped, times 255,
    truncated, uint8."""
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def vertex_normals(vertices, faces):
    """Area-weighted vertex normals (V, 3) float32, numpy."""
    v = vertices.astype(np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]],
                  v[faces[:, 2]] - v[faces[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return (vn / np.linalg.norm(vn, axis=1, keepdims=True)).astype(
        np.float32)


def asset_arrays(size=ASSET, tex=TEX):
    """The asset as numpy arrays, faces sorted by material: vertices,
    faces (F, 3) int64, uvs (U, 2) (the distinct UVs) with face_uvs_idx,
    vertex normals, material_assignments (F,) int64 and the maps, HWC
    float32 in [0, 1]: checker, specular (grey, from the roughness map),
    normal ((n + 1) / 2 of the bump), metallic-roughness (G roughness, B
    0.7) and specular-glossiness (RGBA, A = 1 − roughness)."""
    a = _sibling("torch_easy_render").scene_arrays(*size, tex)
    order = np.argsort(a["material_assignments"], kind="stable")
    faces = a["faces"][order].astype(np.int64)
    uvs, inverse = np.unique(a["face_uvs"][order].reshape(-1, 2), axis=0,
                             return_inverse=True)
    rough = a["roughness"][0]
    spec = np.repeat(rough[..., None] * 0.5 + 0.1, 3, axis=-1)
    return {
        "vertices": a["vertices"], "faces": faces,
        "uvs": uvs.astype(np.float32),
        "face_uvs_idx": inverse.reshape(-1, 3).astype(np.int64),
        "normals": vertex_normals(a["vertices"], faces),
        "material_assignments": a["material_assignments"][order].astype(
            np.int64),
        "checker": a["checker"].transpose(1, 2, 0),
        "specular": spec.astype(np.float32),
        "normal": (a["bump"].transpose(1, 2, 0) + 1.0) / 2.0,
        "metal_rough": np.stack([np.zeros_like(rough), rough,
                                 np.full_like(rough, 0.7)], -1),
        "spec_gloss": np.concatenate([spec, 1.0 - rough[..., None]], -1),
    }


def _write_obj(directory, a):
    """OBJ + MTL + two PNG maps → the OBJ's path."""
    kio.utils.write_image(a["checker"], os.path.join(directory,
                                                     "checker.png"))
    kio.utils.write_image(a["specular"][..., :1],
                          os.path.join(directory, "specular.png"))
    with open(os.path.join(directory, "asset.mtl"), "w") as f:
        for name, kd, ks, maps in (
                ("checker", KD[0], KS[0], ["map_Kd checker.png"]),
                ("metal", KD[1], KS[1], ["map_Ks specular.png"])):
            kd, ks = np.float32(kd), np.float32(ks)
            f.write(f"newmtl {name}\nKd {kd[0]} {kd[1]} {kd[2]}\n"
                    f"Ks {ks[0]} {ks[1]} {ks[2]}\n"
                    + "".join(m + "\n" for m in maps))
    lines = ["mtllib asset.mtl"]
    lines += [f"v {x} {y} {z}" for x, y, z in a["vertices"]]
    lines += [f"vt {u} {v}" for u, v in a["uvs"]]
    lines += [f"vn {x} {y} {z}" for x, y, z in a["normals"]]
    corners = np.stack([a["faces"], a["face_uvs_idx"], a["faces"]], -1) + 1
    for m, name in enumerate(("checker", "metal")):
        lines.append(f"usemtl {name}")
        lines += ["f " + " ".join("/".join(map(str, c)) for c in face)
                  for face in corners[a["material_assignments"] == m]]
    path = os.path.join(directory, "asset.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class _GlbBuffer:
    """The BIN chunk of a GLB, its buffer views and accessors."""

    _TYPES = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125}

    def __init__(self):
        self.data, self.views, self.accessors = bytearray(), [], []

    def view(self, raw):
        self.data += b"\0" * (-len(self.data) % 4)
        self.views.append({"buffer": 0, "byteOffset": len(self.data),
                           "byteLength": len(raw)})
        self.data += raw
        return len(self.views) - 1

    def accessor(self, arr):
        arr = np.ascontiguousarray(arr)
        kind = {1: "SCALAR", 2: "VEC2", 3: "VEC3"}[
            1 if arr.ndim == 1 else arr.shape[1]]
        acc = {"bufferView": self.view(arr.tobytes()),
               "componentType": self._TYPES[arr.dtype],
               "count": arr.shape[0], "type": kind}
        if kind == "VEC3":
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        self.accessors.append(acc)
        return len(self.accessors) - 1


def _node_matrix(trs):
    """The 4x4 world transform a glTF node's TRS gives."""
    t, axis, angle, s = trs
    m = np.eye(4)
    m[:3, :3] = _rotation(axis, angle) * s
    m[:3, 3] = t
    return m


def _write_glb(directory, a):
    """GLB of two nodes → its path. Each node's local vertices are its
    world vertices moved back through the inverse of its TRS, so the
    import's world transform puts them where the OBJ has them."""
    buf = _GlbBuffer()
    images = []
    for name, key in (("base", "checker"), ("metal_rough", "metal_rough"),
                      ("normal", "normal"), ("spec_gloss", "spec_gloss")):
        path = os.path.join(directory, f"glb_{name}.png")
        kio.utils.write_image(a[key], path)
        with open(path, "rb") as f:
            images.append({"bufferView": buf.view(f.read()),
                           "mimeType": "image/png"})
    nodes, meshes = [], []
    for m, trs in enumerate(NODE_TRS):
        sel = a["material_assignments"] == m
        faces, fuv = a["faces"][sel], a["face_uvs_idx"][sel]
        # glTF has one index for all attributes: a vertex per (v, uv) pair
        keys, inverse = np.unique(faces * len(a["uvs"]) + fuv,
                                  return_inverse=True)
        v_ids, uv_ids = keys // len(a["uvs"]), keys % len(a["uvs"])
        world = _node_matrix(trs)
        pos_h = np.concatenate([a["vertices"][v_ids].astype(np.float64),
                                np.ones((len(keys), 1))], 1)
        local = (pos_h @ np.linalg.inv(world).T)[:, :3].astype(np.float32)
        lin = world[:3, :3]
        nrm = a["normals"][v_ids].astype(np.float64) @ lin
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)
        uv = a["uvs"][uv_ids]
        uv_gl = np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1).astype(np.float32)
        meshes.append({"primitives": [{
            "attributes": {"POSITION": buf.accessor(local),
                           "NORMAL": buf.accessor(nrm),
                           "TEXCOORD_0": buf.accessor(uv_gl)},
            "indices": buf.accessor(inverse.reshape(-1).astype(np.uint32)),
            "material": m}]})
        t, axis, angle, s = trs
        nodes.append({"mesh": m, "translation": list(t),
                      "rotation": _quaternion(axis, angle).tolist(),
                      "scale": [s, s, s]})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}], "nodes": nodes, "meshes": meshes,
        "extensionsUsed": ["KHR_materials_pbrSpecularGlossiness"],
        "materials": [
            {"name": "checker",
             "pbrMetallicRoughness": {
                 "baseColorTexture": {"index": 0},
                 "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 2}},
            {"name": "metal", "extensions": {
                "KHR_materials_pbrSpecularGlossiness": {
                    "diffuseFactor": list(KD[1]) + [1.0],
                    "specularFactor": list(KS[1]),
                    "glossinessFactor": 0.9,
                    "specularGlossinessTexture": {"index": 3}}}}],
        "textures": [{"source": i} for i in range(len(images))],
        "images": images,
        "accessors": buf.accessors, "bufferViews": buf.views,
        "buffers": [{"byteLength": len(buf.data)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    data = bytes(buf.data) + b"\0" * (-len(buf.data) % 4)
    path = os.path.join(directory, "asset.glb")
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(data)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(data), 0x004E4942) + data)
    return path


def write_asset(directory, size=ASSET, tex=TEX):
    """Write the asset as OBJ (+ MTL, PNG), GLB, binary PLY and OFF into
    ``directory`` → ({format: path}, the arrays written)."""
    a = asset_arrays(size, tex)
    paths = {"obj": _write_obj(directory, a),
             "glb": _write_glb(directory, a),
             "ply": os.path.join(directory, "asset.ply"),
             "off": os.path.join(directory, "asset.off")}
    v, colors = a["vertices"], (a["normals"] + 1.0) / 2.0
    kio.ply.write_ply(paths["ply"], {
        "x": v[:, 0], "y": v[:, 1], "z": v[:, 2], "red": colors[:, 0],
        "green": colors[:, 1], "blue": colors[:, 2]}, faces=a["faces"])
    kio.off.export_mesh(paths["off"], v, a["faces"])
    return paths, a


def import_asset(paths, device=None):
    """``io.import_mesh`` of each file on ``device`` (the CUDA device
    unless named) → {format: SurfaceMesh}; the OBJ with its materials as
    PBR materials."""
    device = resolve_device(device, "import_asset")
    return {fmt: kio.import_mesh(path, device=device,
                                 **(dict(with_materials=True,
                                         raw_materials=False)
                                    if fmt == "obj" else {}))
            for fmt, path in paths.items()}


def obj_reference(a, device=None):
    """The mesh that the OBJ describes, built in memory on ``device``:
    the geometry written, and the materials that ``raw_material_to_pbr``
    makes of the MTL's values, with its maps as 8-bit files hold them."""
    device = resolve_device(device, "obj_reference")

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    def chw(key, channels=3):
        img = _to8(a[key][..., :channels]).astype(np.float32) / 255.0
        return t(np.repeat(img, 3 // channels, -1).transpose(2, 0, 1))

    materials = [
        PBRMaterial(material_name="checker", diffuse_color=t(KD[0]),
                    specular_color=t(KS[0]), diffuse_texture=chw("checker")),
        PBRMaterial(material_name="metal", diffuse_color=t(KD[1]),
                    specular_color=t(KS[1]),
                    specular_texture=chw("specular", 1))]
    return SurfaceMesh(vertices=t(a["vertices"]), faces=t(a["faces"]),
                       uvs=t(a["uvs"]), face_uvs_idx=t(a["face_uvs_idx"]),
                       material_assignments=t(a["material_assignments"]),
                       materials=materials)


def render_asset(mesh, res=RES):
    """``render_mesh(default_camera(res), mesh, default_lighting())`` on
    the mesh's device → the passes."""
    return _sibling("torch_easy_render").render(mesh, res=res)


def _random_gaussians(n, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    return {"positions": (rng.randn(n, 3) * 0.5).astype(np.float32),
            "orientations": (q / np.linalg.norm(q, axis=1, keepdims=True))
            .astype(np.float32),
            "scales": np.exp(rng.randn(n, 3) * 0.5 - 4.0).astype(np.float32),
            "opacities": rng.uniform(0.05, 0.95, n).astype(np.float32),
            "sh_coeff": (rng.randn(n, (SH_DEGREE + 1) ** 2, 3) * 0.3)
            .astype(np.float32)}


def gs_transform():
    """The 4x4 transform of the 3DGS scene: a rotation times a uniform
    scale, float32."""
    m = np.eye(4)
    m[:3, :3] = _rotation(*GS_ROTATION) * GS_SCALE
    return m.astype(np.float32)


def gaussian_scene(directory, n=GAUSSIANS, device=None, seed=0):
    """Export ``n`` seeded gaussians at SH degree 3, import them on
    ``device``, transform them, export the result and import it again →
    dict of the paths, the first import, the transformed cloud (a
    GaussianSplatModel) and the second import."""
    device = resolve_device(device, "gaussian_scene")
    first = os.path.join(directory, "scene.ply")
    g = _random_gaussians(n, seed)
    kio.ply.export_gaussiancloud(first, g["positions"], g["orientations"],
                                 g["scales"], g["opacities"], g["sh_coeff"])
    model = kio.import_gaussiancloud(first, device=device)
    pos, orient, scales, sh = transform_gaussians(
        model.positions, model.orientations, model.scales,
        torch.as_tensor(gs_transform(), device=device),
        sh_coeff=model.sh_coeff)
    moved = GaussianSplatModel(positions=pos, orientations=orient,
                               scales=scales, opacities=model.opacities,
                               sh_coeff=sh, sh_degree=SH_DEGREE,
                               strict_checks=False)
    second = os.path.join(directory, "moved.ply")
    kio.ply.export_gaussiancloud(second, moved.positions, moved.orientations,
                                 moved.scales, moved.opacities,
                                 moved.sh_coeff)
    return {"paths": (first, second), "imported": model, "moved": moved,
            "reimported": kio.import_gaussiancloud(second, device=device)}


def _deformed_icosphere(seed):
    v, f = _sibling("torch_tutorial_camera_rasterization").make_icosphere(
        ICO_LEVEL)
    rng = np.random.RandomState(seed)
    k = rng.uniform(1.0, 4.0, 3)
    r = 1.0 + 0.15 * np.sin(k[0] * v[:, 0] + k[1] * v[:, 1]) \
        * np.cos(k[2] * v[:, 2])
    return (v * r[:, None] * rng.uniform(0.6, 1.0, 3)).astype(np.float32), f


def write_shapenet(root, models=MODELS):
    """A ShapeNetV2 tree of ``models`` deformed level-3 icospheres, half in
    each of ``SYNSETS``: <root>/<synset>/<model>/models/model_normalized.obj
    → root."""
    for i in range(models):
        d = os.path.join(root, SYNSETS[i % 2], f"model_{i:03d}", "models")
        os.makedirs(d, exist_ok=True)
        v, f = _deformed_icosphere(i)
        kio.obj.export_mesh(os.path.join(d, "model_normalized.obj"),
                            vertices=v, faces=f)
    return root


class IndexedItems:
    """A dataset's items with their index, under ``"index"``."""

    def __init__(self, source):
        self.source = source

    def __len__(self):
        return len(self.source)

    def __getitem__(self, index):
        return {**self.source[index], "index": index}


class SurfaceSamples:
    """The preprocessing transform: ``samples`` points on the item's mesh,
    from a CPU generator seeded by its index → {"points", "synset",
    "index"}. Its workers unpickle it by this module's name."""

    def __init__(self, samples=SAMPLES):
        self.samples = samples

    def __call__(self, item):
        mesh = item["mesh"]
        gen = torch.Generator().manual_seed(item["index"])
        points, _ = sample_points(mesh.vertices[None].cpu(),
                                  mesh.faces.cpu(), self.samples,
                                  generator=gen)
        return {"points": points[0], "synset": item["synset"],
                "index": item["index"]}


def dataset(root, cache_dir, device=None, num_workers=WORKERS,
            samples=SAMPLES):
    """``CachedDataset`` over ``ShapeNetV2(root, split=1.0,
    device="cpu")`` (a source is read on the host) with
    :class:`SurfaceSamples` preprocessed on ``num_workers`` spawned
    workers, items on ``device`` → (the dataset, its points stacked (N,
    samples, 3) on the device)."""
    device = resolve_device(device, "dataset")
    ds = kio.CachedDataset(IndexedItems(kio.ShapeNetV2(root, split=1.0,
                                                       device="cpu")),
                           preprocessing_transform=SurfaceSamples(samples),
                           cache_dir=cache_dir, num_workers=num_workers,
                           device=device)
    return ds, torch.stack([ds[i]["points"] for i in range(len(ds))])


def vertex_adjacency(faces, num_vertices):
    """The undirected edges of ``faces`` as a COO tuple ``(indices (2,
    nnz) int64, values (nnz,) float32 ones, (V, V))``, both directions,
    on the faces' device."""
    f = faces.long()
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = torch.unique(torch.cat([e, e.flip(1)]), dim=0)
    return (e.T.contiguous(), torch.ones(e.shape[0], device=f.device),
            (num_vertices, num_vertices))


def graph_conv(mesh, batch=GCN_BATCH, widths=GCN_WIDTHS, seed=0):
    """``GraphConv`` layers ``widths`` on the mesh's vertex graph, made on
    its device → (a function running forward and backward at B = ``batch``
    and returning the loss, the layers, the inputs, the adjacency)."""
    device = mesh.vertices.device
    gen = torch.Generator(device).manual_seed(seed)
    layers = torch.nn.ModuleList(
        GraphConv(a, b, key=gen) for a, b in zip(widths[:-1], widths[1:]))
    adj = vertex_adjacency(mesh.faces, mesh.vertices.shape[0])
    feats = mesh.vertices[None] * torch.linspace(0.5, 1.5, batch,
                                                 device=device)[:, None,
                                                                None]

    def step():
        h = feats
        for i, layer in enumerate(layers):
            h = layer(h, adj, normalize_adj=True)
            if i < len(layers) - 1:
                h = torch.relu(h)
        loss = (h ** 2).mean()
        layers.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    return step, layers, feats, adj


def main(device=None, smoke=False, verbose=True):
    """Every part above on ``device`` (the CUDA device unless named), at
    full size or at the ``SMOKE`` sizes → dict of the results."""
    device = resolve_device(device, "main")
    s = SMOKE if smoke else dict(asset=ASSET, tex=TEX, res=RES,
                                 gaussians=GAUSSIANS, models=MODELS,
                                 samples=SAMPLES)
    with tempfile.TemporaryDirectory() as d:
        paths, a = write_asset(d, s["asset"], s["tex"])
        meshes = import_asset(paths, device)
        for fmt in ("ply", "off"):
            assert torch.equal(meshes[fmt].faces.cpu(),
                               torch.from_numpy(a["faces"])), fmt
        passes = {fmt: render_asset(meshes[fmt], s["res"])
                  for fmt in ("obj", "glb")}
        gs = gaussian_scene(d, s["gaussians"], device)
        ds, points = dataset(write_shapenet(os.path.join(d, "shapenet"),
                                            s["models"]),
                             os.path.join(d, "cache"), device,
                             samples=s["samples"])
        step, *_ = graph_conv(meshes["obj"])
        loss = float(step())
    covered = {k: int((p["face_idx"] >= 0).sum()) for k, p in passes.items()}
    ok = (all(bool(torch.isfinite(p["render"]).all())
              for p in passes.values())
          and min(covered.values()) > 0 and np.isfinite(loss)
          and points.shape == (s["models"], s["samples"], 3)
          and torch.equal(gs["reimported"].positions, gs["moved"].positions))
    if verbose:
        print(f"asset: {int(meshes['obj'].faces.shape[0])} faces; "
              f"renders at {s['res']}² cover {covered} pixels; "
              f"{s['gaussians']} gaussians round trip; dataset points "
              f"{tuple(points.shape)}; GraphConv loss {loss:.5f}; "
              f"ok {ok}", flush=True)
    return {"meshes": meshes, "passes": passes, "gaussians": gs,
            "points": points, "gcn_loss": loss, "ok": ok}


if __name__ == "__main__":
    args = sys.argv[1:]
    out = main(next((x for x in args if x != "smoke"), None),
               smoke="smoke" in args)
    sys.exit(0 if out["ok"] else 1)
