"""The port's mesh I/O (``kaolin_tpu_torch/io``: OBJ/MTL, glTF/GLB, PLY,
OFF, the dispatcher and the images) against kaolin_tpu's, on the CPU.

Both packages read the same files, written here under ``tmp_path`` from
seeded numpy inputs: every parsed array equal, integers and float32 alike;
what passes through math after parsing (glTF's node transforms and
texture factors) within 1e-6 of its max|x|. Images, read and written
through Pillow by both: each caller's conversion of L, LA, RGB, RGBA and P
PNGs, 16-bit, interlaced and JPEG files equal to JAX's, ``write_image``'s
files equal to JAX's byte for byte, and without Pillow an ImportError
that names the file. F29: JAX's merged glTF mesh drops the UVs and
normals, the port's keeps them.
"""

import base64
import io as _io
import json
import os
import struct
import subprocess
import sys
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import kaolin_tpu.io as jio
import kaolin_tpu_torch.io as tio
from tests.torch_io_parity import (
    assert_close,
    assert_materials_equal,
    assert_meshes_equal,
    host,
)
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLTF_RTOL = 1e-6
RNG = np.random.RandomState(0)


# -- images ----------------------------------------------------------------
def _smooth(h=24, w=20, ch=3, seed=0):
    """A smooth image with noise (Pillow's filter choice varies by row on
    it) → uint8 (h, w, ch)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs * 7 + ys * 3)[..., None] + np.arange(ch) * 40
    return ((base + rng.randint(0, 12, (h, w, ch))) % 256).astype(np.uint8)


def _pil_png(img, **kw):
    buf = _io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _interlaced_png(pixels):
    """PNG bytes of uint8 ``pixels`` (h, w, 3), Adam7-interlaced, every
    row of every pass unfiltered."""
    h, w, _ = pixels.shape
    raw = b""
    for r0, c0, dr, dc in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                           (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                           (1, 0, 2, 1)):
        sub = pixels[r0::dr, c0::dc]
        if sub.size:
            raw += b"".join(b"\0" + row.tobytes() for row in sub)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _pil_files():
    """Image files in each PNG mode with Pillow's default and optimized
    filter choice, and a 16-bit PNG, an interlaced one, a palette with
    tRNS and a JPEG."""
    rgb = _smooth()
    files = {
        "L": Image.fromarray(rgb[..., 0], "L"),
        "LA": Image.fromarray(rgb[..., :2], "LA"),
        "RGB": Image.fromarray(rgb, "RGB"),
        "RGBA": Image.fromarray(_smooth(ch=4), "RGBA"),
        "P": Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                          colors=40),
    }
    out = {f"{m}-{opt}": _pil_png(img, optimize=opt)
           for m, img in files.items() for opt in (False, True)}
    out["16-bit"] = _pil_png(Image.fromarray(rgb[..., 0].astype(np.uint16)
                                             * 257))
    out["interlaced"] = _interlaced_png(rgb)
    out["palette-trns"] = _pil_png(
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16),
        transparency=0)
    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG")
    out["jpeg"] = buf.getvalue()
    return out


PIL_FILES = _pil_files()


def _gltf_texture(package, data, with_alpha):
    """glTF's texture read of ``data`` as a data-URI image, by the port
    (``_Reader.texture``) or by JAX (``_read_texture``)."""
    gltf = {"textures": [{"source": 0}],
            "images": [{"uri": "data:image/png;base64,"
                        + base64.b64encode(data).decode()}]}
    if package == "port":
        return tio.gltf._Reader(gltf, [], ".", "cpu").texture(0, with_alpha)
    return jio.gltf._read_texture(gltf, [], ".", 0, with_alpha)


@pytest.mark.parametrize("name", sorted(PIL_FILES))
@pytest.mark.parametrize("caller", ["read_image", "read_image_from_buffer",
                                    "obj", "gltf-rgb", "gltf-rgba"])
def test_image_callers_read_as_jax(name, caller, tmp_path):
    """Each caller's conversion of one file equals JAX's, value and dtype:
    ``read_image`` and ``read_image_from_buffer`` (the file's own values,
    8-bit ones over 255), the OBJ's texture (RGB, CHW) and glTF's (RGB, or
    RGB and alpha), in every PNG mode and for the files that are not
    8-bit or not PNG."""
    data = PIL_FILES[name]
    path = tmp_path / "img.bin"
    path.write_bytes(data)
    if caller == "read_image":
        got, want = (tio.utils.read_image(path, device="cpu"),
                     jio.utils.read_image(path))
    elif caller == "read_image_from_buffer":
        got, want = (tio.utils.read_image_from_buffer(data, device="cpu"),
                     jio.utils.read_image_from_buffer(data))
    elif caller == "obj":
        got, want = (tio.obj._read_image(str(path), "cpu"),
                     jio.obj._read_image(str(path)))
    else:
        alpha = caller == "gltf-rgba"
        got, want = (_gltf_texture("port", data, alpha),
                     _gltf_texture("jax", data, alpha))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert host(g).dtype == host(w).dtype
        assert_close(g, w)


@pytest.mark.parametrize("shape", [(13, 7), (13, 7, 1), (13, 7, 2),
                                   (13, 7, 3), (13, 7, 4)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_write_image_as_jax(shape, dtype, tmp_path):
    """``write_image`` of floats (clipped, times 255, truncated) or of
    uint8, from a tensor: the file's bytes equal JAX's from the same
    array."""
    rng = np.random.RandomState(1)
    img = rng.uniform(-0.1, 1.1, shape).astype(np.float32) \
        if dtype == "float32" else rng.randint(0, 256, shape).astype(
            np.uint8)
    tio.utils.write_image(torch.from_numpy(img), tmp_path / "t.png")
    jio.utils.write_image(img, tmp_path / "j.png")
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


def test_images_without_pillow(tmp_path):
    """With Pillow's import blocked, ``kaolin_tpu_torch.io`` imports, and
    reading or writing an image raises an ImportError that names the file
    and Pillow."""
    Image.fromarray(_smooth()).save(tmp_path / "rgb.png")
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'PIL':\n"
        "            raise ImportError('blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, kaolin_tpu_torch.io as io\n"
        f"d = {str(tmp_path)!r}\n"
        "calls = [lambda: io.utils.read_image(d + '/rgb.png', device='cpu'),\n"
        "         lambda: io.obj._read_image(d + '/rgb.png', 'cpu'),\n"
        "         lambda: io.utils.write_image(np.zeros((2, 2)),\n"
        "                                      d + '/out.png')]\n"
        "for call, name in zip(calls, ('rgb.png', 'rgb.png', 'out.png')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert name in str(e) and 'Pillow' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- OBJ -------------------------------------------------------------------
def _write(path, text):
    path.write_text(text)
    return str(path)


def _obj_textures(tmp_path):
    """Three textures in three modes beside the OBJ files."""
    Image.open(_io.BytesIO(PIL_FILES["P-True"])).save(tmp_path / "kd.png")
    Image.open(_io.BytesIO(PIL_FILES["L-False"])).save(tmp_path / "ks.png")
    Image.open(_io.BytesIO(PIL_FILES["RGBA-True"])).save(tmp_path / "n.png")


MTL = """# two materials and one that no face uses
newmtl red
Kd 0.8 0.1 0.1
Ks 0.25 0.25 0.25
map_Kd kd.png
newmtl blue
Ka 0.1 0.1 0.1
Kd 0.1 0.2 0.9
map_Ks ks.png
newmtl unused
Kd 0.5 0.5 0.5
"""


def _obj_text(kind):
    """OBJ files: triangles with negative indices and two materials, quads,
    mixed polygons, a missing material, a missing texture."""
    v = RNG.rand(8, 3).astype(np.float32) if kind == "quads" else \
        np.random.RandomState(2).rand(8, 3).astype(np.float32)
    head = "mtllib m.mtl\n" + "".join(f"v {a} {b} {c}\n" for a, b, c in v)
    head += "vt 0.1 0.2\nvt 0.9 0.3\nvt 0.4 0.8\nvt 0.6 0.6\n"
    head += "vn 0 0 1\nvn 0 1 0\nvn 1 0 0\n"
    if kind == "triangles":
        return head + ("usemtl red\nf 1/1/1 2/2/2 3/3/3\nf -1/-1/-1 -2/-2/-2 "
                       "-3/-3/-3\nusemtl blue\nf 4//2 5//2 6//2\n"
                       "f 2 3 4\n")
    if kind == "quads":
        return head + ("usemtl blue\nf 1/1 2/2 3/3 4/4\nf 5/1 6/2 7/3 8/4\n"
                       "usemtl red\nf 1/1 3/2 5/3 7/4\n")
    if kind == "mixed":
        return head + ("f 1 2 3\nusemtl red\nf 1/1/1 2/2/2 3/3/3 4/4/1\n"
                       "usemtl blue\nf 4 5 6 7 8\nf 2/1 4/2 6/3\n")
    if kind == "missing-material":
        return head + "usemtl red\nf 1 2 3\nusemtl gone\nf 2 3 4\n"
    return head.replace("mtllib m.mtl", "mtllib broken.mtl") \
        + "usemtl red\nf 1 2 3\n"


OBJ_CASES = [
    ("triangles", dict(with_materials=True, with_normals=True)),
    ("triangles", dict(with_materials=True, raw_materials=False)),
    ("triangles", dict()),
    ("quads", dict(with_materials=True)),
    ("quads", dict(with_materials=True, triangulate=True,
                   raw_materials=False)),
    ("mixed", dict(triangulate=True, with_materials=True)),
    ("mixed", dict(with_materials=True, with_normals=True,
                   heterogeneous_mesh_handler="naive")),
    ("mixed", dict(heterogeneous_mesh_handler="homogenize")),
    ("mixed", dict(heterogeneous_mesh_handler="skip")),
    ("mixed", dict(error_handler="ignore")),
    ("missing-material", dict(with_materials=True,
                              error_handler="create_missing")),
    ("missing-material", dict(with_materials=True, error_handler="skip")),
    ("missing-texture", dict(with_materials=True, error_handler="skip")),
]


def _obj_kwargs(pkg, kw):
    """The case's keywords with the handlers named by ``pkg``'s
    functions."""
    handlers = {"naive": "mesh_handler_naive_triangulate",
                "homogenize": "heterogeneous_mesh_handler_naive_homogenize",
                "skip": "heterogeneous_mesh_handler_skip"}
    errors = {"ignore": "ignore_error_handler",
              "skip": "skip_error_handler",
              "create_missing": "create_missing_materials_error_handler"}
    out = dict(kw)
    if "heterogeneous_mesh_handler" in out:
        out["heterogeneous_mesh_handler"] = getattr(
            pkg.utils, handlers[out["heterogeneous_mesh_handler"]])
    if "error_handler" in out:
        out["error_handler"] = getattr(pkg.obj, errors[out["error_handler"]])
    return out


@pytest.mark.parametrize("kind,kw", OBJ_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(OBJ_CASES)])
def test_obj_import_matches_jax(kind, kw, tmp_path):
    """``obj.import_mesh`` on one file: every attribute and material equal
    to JAX's, or None where JAX's is."""
    _obj_textures(tmp_path)
    _write(tmp_path / "m.mtl", MTL)
    (tmp_path / "broken.mtl").write_text(MTL.replace("kd.png", "none.png"))
    path = _write(tmp_path / "a.obj", _obj_text(kind))
    want = jio.obj.import_mesh(path, **_obj_kwargs(jio, kw))
    got = tio.obj.import_mesh(path, device="cpu", **_obj_kwargs(tio, kw))
    if want is None:
        assert got is None
        return
    assert_meshes_equal(got, want)


@pytest.mark.parametrize("kind,error", [
    ("mixed", "NonHomogeneousMeshError"),
    ("missing-material", "MaterialNotFoundError"),
    ("missing-texture", "MaterialLoadError")])
def test_obj_default_error_handler_raises_as_jax(kind, error, tmp_path):
    """With the default handler both packages raise the same error."""
    _obj_textures(tmp_path)
    _write(tmp_path / "m.mtl", MTL)
    (tmp_path / "broken.mtl").write_text(MTL.replace("kd.png", "none.png"))
    path = _write(tmp_path / "a.obj", _obj_text(kind))
    for pkg, extra in ((jio, {}), (tio, {"device": "cpu"})):
        with pytest.raises(Exception) as err:
            pkg.obj.import_mesh(path, with_materials=True, **extra)
        assert type(err.value).__name__ == error


def test_obj_load_mtl_and_pbr_match_jax(tmp_path):
    """``load_mtl`` (with a normal map under ``bump``) and
    ``raw_material_to_pbr`` as JAX's."""
    _obj_textures(tmp_path)
    path = _write(tmp_path / "m.mtl", MTL + "bump n.png\n")
    want = jio.obj.load_mtl(path)
    got = tio.obj.load_mtl(path, device="cpu")
    assert sorted(got) == sorted(want)
    assert_materials_equal([got[k] for k in sorted(got)],
                           [want[k] for k in sorted(want)])
    # the maps load_mtl reads; a bump map enters raw_material_to_pbr
    # through the dict, mapped by 2x − 1
    raw = {**want["red"], "bump": jio.obj._read_image(str(tmp_path
                                                           / "n.png"))}
    port_raw = {k: (torch.from_numpy(np.array(v)) if k != "material_name"
                    else v) for k, v in raw.items()}
    assert_materials_equal([tio.obj.raw_material_to_pbr(port_raw)],
                           [jio.obj.raw_material_to_pbr(raw)])


def test_obj_export_matches_jax_bytes(tmp_path):
    """``obj.export_mesh`` writes JAX's file byte for byte, from arguments
    and from a mesh; the import of it equals JAX's."""
    v = RNG.randn(30, 3).astype(np.float32)
    f = RNG.randint(0, 30, (40, 3))
    uv = RNG.rand(25, 2).astype(np.float32)
    fuv = RNG.randint(0, 25, (40, 3))
    fuv[3, 1] = -1
    n = RNG.randn(12, 3).astype(np.float32)
    fn = RNG.randint(0, 12, (40, 3))
    args = dict(vertices=v, faces=f, uvs=uv, face_uvs_idx=fuv, normals=n,
                face_normals_idx=fn)
    jio.obj.export_mesh(tmp_path / "j.obj", **args)
    tio.obj.export_mesh(tmp_path / "t.obj", **{
        k: torch.from_numpy(x) for k, x in args.items()})
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    mesh = tio.obj.import_mesh(str(tmp_path / "t.obj"), with_normals=True,
                               device="cpu")
    assert_meshes_equal(mesh, jio.obj.import_mesh(str(tmp_path / "j.obj"),
                                                  with_normals=True))
    tio.obj.export_mesh(tmp_path / "m.obj", mesh=mesh)
    jio.obj.export_mesh(tmp_path / "jm.obj", mesh=jio.obj.import_mesh(
        str(tmp_path / "j.obj"), with_normals=True))
    assert (tmp_path / "m.obj").read_bytes() == \
        (tmp_path / "jm.obj").read_bytes()


def test_material_grouping_matches_jax():
    """``group_materials_by_name`` and
    ``process_materials_and_assignments`` (face ids and (start, end) rows,
    a missing material under two handlers) as JAX's."""
    mats = [{"material_name": n} for n in ("b", "a", "b", "", "c")]
    assign = np.array([0, 1, 2, 3, 4, 0, 4, -1])
    got = tio.materials.group_materials_by_name(mats, assign)
    want = jio.materials.group_materials_by_name(mats, assign)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for handler in ("skip_error_handler",
                    "create_missing_materials_error_handler"):
        out = []
        for pkg in (tio, jio):
            out.append(pkg.materials.process_materials_and_assignments(
                {"x": {"material_name": "x"}, "a": {"material_name": "a"}},
                {"x": np.array([[0, 2], [5, 6]]), "a": np.array([3]),
                 "gone": np.array([4])},
                getattr(pkg.obj, handler), 8))
        assert out[0][0] == out[1][0]
        np.testing.assert_array_equal(out[0][1], out[1][1])


# -- glTF ------------------------------------------------------------------
def _gltf_doc(tmp_path, binary=False):
    """A glTF of four primitives on three nodes (one a child) in two
    scenes (the default is scene 1): an interleaved buffer view, uint16 and
    uint32 indices and a primitive without indices; buffer 0 external (or
    the GLB's BIN chunk), buffer 1 a data URI; a metallic-roughness
    material with three textures and factors, a specular-glossiness one
    with an RGBA texture, a transmission one with a texture, one of plain
    factors; images from a file, a data URI and a buffer view → path."""
    rng = np.random.RandomState(5)
    b0, b1 = bytearray(), bytearray()
    views, accessors = [], []

    def view(buf, raw, bi, stride=None):
        buf += b"\0" * (-len(buf) % 4)
        v = {"buffer": bi, "byteOffset": len(buf), "byteLength": len(raw)}
        if stride:
            v["byteStride"] = stride
        views.append(v)
        buf += raw
        return len(views) - 1

    def acc(vi, ctype, count, kind, offset=0):
        accessors.append({"bufferView": vi, "componentType": ctype,
                          "count": count, "type": kind,
                          "byteOffset": offset})
        return len(accessors) - 1

    prims = []
    for p in range(4):
        nv = 6 + p
        pos = rng.randn(nv, 3).astype(np.float32)
        nrm = rng.randn(nv, 3).astype(np.float32)
        uv = rng.rand(nv, 2).astype(np.float32)
        attrs = {}
        if p == 0:      # interleaved position | normal | uv, stride 32
            inter = np.concatenate([pos, nrm, uv], 1).tobytes()
            vi = view(b0, inter, 0, stride=32)
            attrs = {"POSITION": acc(vi, 5126, nv, "VEC3"),
                     "NORMAL": acc(vi, 5126, nv, "VEC3", 12),
                     "TEXCOORD_0": acc(vi, 5126, nv, "VEC2", 24)}
        else:
            buf, bi = (b1, 1) if p == 2 else (b0, 0)
            attrs["POSITION"] = acc(view(buf, pos.tobytes(), bi), 5126, nv,
                                    "VEC3")
            if p != 3:
                attrs["NORMAL"] = acc(view(buf, nrm.tobytes(), bi), 5126,
                                      nv, "VEC3")
                attrs["TEXCOORD_0"] = acc(view(buf, uv.tobytes(), bi),
                                          5126, nv, "VEC2")
        prim = {"attributes": attrs, "material": p}
        if p != 3:
            idx = rng.randint(0, nv, 12)
            dt, ct = (np.uint16, 5123) if p % 2 == 0 else (np.uint32, 5125)
            prim["indices"] = acc(view(b0, idx.astype(dt).tobytes(), 0), ct,
                                  12, "SCALAR")
        prims.append(prim)
    Image.open(_io.BytesIO(PIL_FILES["RGB-True"])).save(tmp_path / "c.png")
    images = [{"uri": "c.png"},
              {"uri": "data:image/png;base64,"
               + base64.b64encode(PIL_FILES["P-True"]).decode()},
              {"bufferView": view(b0, PIL_FILES["RGBA-True"], 0),
               "mimeType": "image/png"},
              {"uri": "data:image/png;base64,"
               + base64.b64encode(PIL_FILES["LA-True"]).decode()}]
    materials = [
        {"name": "mr", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
            "metallicRoughnessTexture": {"index": 1},
            "metallicFactor": 0.6, "roughnessFactor": 0.3},
         "normalTexture": {"index": 3}},
        {"name": "sg", "extensions": {"KHR_materials_pbrSpecularGlossiness": {
            "diffuseTexture": {"index": 1},
            "diffuseFactor": [0.5, 0.6, 0.7, 1.0],
            "specularFactor": [0.3, 0.2, 0.1], "glossinessFactor": 0.7,
            "specularGlossinessTexture": {"index": 2}}},
         "pbrMetallicRoughness": {"baseColorFactor": [1, 0, 0, 1]}},
        {"name": "tr", "pbrMetallicRoughness": {
            "baseColorFactor": [0.2, 0.3, 0.4, 1.0], "metallicFactor": 0.1},
         "extensions": {"KHR_materials_transmission": {
             "transmissionFactor": 0.8,
             "transmissionTexture": {"index": 3}}}},
        {"name": "plain", "pbrMetallicRoughness": {
            "roughnessFactor": 0.45},
         "extensions": {"KHR_materials_transmission": {
             "transmissionFactor": 0.25}}}]
    doc = {
        "asset": {"version": "2.0"}, "scene": 1,
        "scenes": [{"nodes": [0]}, {"nodes": [1, 2]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, 0, 0]},
            {"mesh": 1, "rotation": [0.1, 0.2, 0.3, 0.927],
             "scale": [1.5, 0.5, 2.0], "children": [3]},
            {"mesh": 2, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0,
                                   0.1, 0.2, 0.3, 1]},
            {"mesh": 3, "translation": [0, 1, 0]}],
        "meshes": [{"primitives": [prims[0]]}, {"primitives": [prims[1]]},
                   {"primitives": [prims[2]]}, {"primitives": [prims[3]]}],
        "materials": materials,
        "textures": [{"source": i} for i in range(4)], "images": images,
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"byteLength": len(b0)} if binary else
                    {"uri": "b0.bin", "byteLength": len(b0)},
                    {"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(bytes(b1)).decode(),
                     "byteLength": len(b1)}]}
    if not binary:
        (tmp_path / "b0.bin").write_bytes(bytes(b0))
        return _write(tmp_path / "a.gltf", json.dumps(doc))
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    data = bytes(b0) + b"\0" * (-len(b0) % 4)
    path = tmp_path / "a.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 28 + len(js)
                                 + len(data))
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(data), 0x004E4942) + data)
    return str(path)


@pytest.mark.parametrize("binary", [False, True], ids=["gltf", "glb"])
@pytest.mark.parametrize("scene", [None, 0, 1, "default"])
def test_gltf_import_meshes_matches_jax(binary, scene, tmp_path):
    """``gltf.import_meshes`` for every scene choice: each primitive's
    arrays and materials as JAX's (the node transforms and the texture
    factors within 1e-6 of max|x|)."""
    path = _gltf_doc(tmp_path, binary)
    want = jio.gltf.import_meshes(path, scene=scene)
    got = tio.gltf.import_meshes(path, scene=scene, device="cpu")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_meshes_equal(g, w, GLTF_RTOL, ("vertices", "normals"))


def test_gltf_merged_mesh_keeps_uvs_f29(tmp_path):
    """F29. A file of two primitives that both carry UVs, normals and a
    material: JAX's merged mesh has no UVs; the port's equals the
    concatenation of its ``import_meshes`` output (indices offset), and
    its vertices, faces, materials and assignments equal JAX's."""
    path = _gltf_doc(tmp_path)
    want = jio.gltf.import_mesh(path, scene=0)     # one primitive
    assert_meshes_equal(tio.gltf.import_mesh(path, scene=0, device="cpu"),
                        want, GLTF_RTOL, ("vertices", "normals"))
    doc = json.loads((tmp_path / "a.gltf").read_text())
    doc["scenes"][0]["nodes"] = [0, 2]               # both with UVs
    _write(tmp_path / "a.gltf", json.dumps(doc))
    want = jio.gltf.import_mesh(path, scene=0)
    got = tio.gltf.import_mesh(path, scene=0, device="cpu")
    parts = tio.gltf.import_meshes(path, scene=0, device="cpu")
    assert len(parts) == 2 and not want.has_attribute("uvs")
    assert got.has_attribute("uvs") and got.has_attribute("normals")
    assert_meshes_equal(got, want, GLTF_RTOL, ("vertices",),
                        extra=("uvs", "face_uvs_idx", "normals",
                               "face_normals_idx"))
    for values, index in (("uvs", "face_uvs_idx"),
                          ("normals", "face_normals_idx")):
        n0 = parts[0].get_attribute(values).shape[0]
        assert_close(got.get_attribute(values),
                     torch.cat([p.get_attribute(values) for p in parts]))
        assert_close(got.get_attribute(index),
                     torch.cat([parts[0].get_attribute(index),
                                parts[1].get_attribute(index) + n0]))
    # the merged UVs give the primitives' own face UVs
    assert_close(got.face_uvs, torch.cat([p.face_uvs for p in parts]))


def test_gltf_merge_without_uvs_on_one_primitive(tmp_path):
    """Where only some primitives carry UVs, the merged mesh has none, as
    JAX's (the default scene: a primitive without them)."""
    path = _gltf_doc(tmp_path)
    want = jio.gltf.import_mesh(path)
    got = tio.gltf.import_mesh(path, device="cpu")
    assert not got.has_attribute("uvs") and not got.has_attribute("normals")
    assert_meshes_equal(got, want, GLTF_RTOL, ("vertices",))


# -- PLY and OFF -----------------------------------------------------------
def _ply_mesh_file(path, binary, colors, quads):
    v = RNG.rand(12, 3).astype(np.float32)
    f = RNG.randint(0, 12, (10, 4 if quads else 3))
    props = {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]}
    if colors:
        c = RNG.randint(0, 256, (12, 3)).astype(np.float32)
        props.update(red=c[:, 0], green=c[:, 1], blue=c[:, 2])
    jio.ply.write_ply(path, props, faces=f, binary=binary)
    return str(path)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("colors", [True, False], ids=["colors", "plain"])
@pytest.mark.parametrize("quads", [False, True], ids=["tris", "quads"])
def test_ply_import_matches_jax(binary, colors, quads, tmp_path):
    """``read_ply`` (the port's structured read of fixed-length lists
    against JAX's item loop), ``import_mesh`` and ``import_pointcloud`` as
    JAX's; the port's ``write_ply`` writes JAX's bytes."""
    path = _ply_mesh_file(tmp_path / "m.ply", binary, colors, quads)
    want, got = jio.ply.read_ply(path), tio.ply.read_ply(path)
    assert got.keys() == want.keys()
    for el in want:
        assert got[el].keys() == want[el].keys()
        for k in want[el]:
            assert got[el][k].dtype == want[el][k].dtype, (el, k)
            np.testing.assert_array_equal(got[el][k], want[el][k])
    assert_meshes_equal(tio.ply.import_mesh(path, device="cpu"),
                        jio.ply.import_mesh(path))
    for g, w in zip(tio.ply.import_pointcloud(path, device="cpu"),
                    jio.ply.import_pointcloud(path)):
        assert (g is None) == (w is None)
        if w is not None:
            assert_close(g, w)
    data = jio.ply.read_ply(path)
    props = {k: data["vertex"][k] for k in data["vertex"]}
    faces = data["face"]["vertex_indices"]
    jio.ply.write_ply(tmp_path / "j.ply", props, faces=faces, binary=binary)
    tio.ply.write_ply(tmp_path / "t.ply", props, faces=faces, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_ply_mixed_face_sizes(tmp_path):
    """A binary PLY of a triangle and a quad: JAX's reader raises (F32);
    the port's reads the lists as an object array, as both packages' ASCII
    readers do, and fans the quad into two triangles."""
    v = RNG.rand(5, 3).astype(np.float32)
    path = tmp_path / "r.ply"
    path.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 2\nproperty list uchar int vertex_indices\n"
        b"end_header\n" + v.tobytes() + struct.pack("<B3i", 3, 0, 1, 2)
        + struct.pack("<B4i", 4, 1, 2, 3, 4))
    with pytest.raises(ValueError):
        jio.ply.read_ply(str(path))
    faces = tio.ply.read_ply(str(path))["face"]["vertex_indices"]
    assert faces.dtype == object and [list(f) for f in faces] == \
        [[0, 1, 2], [1, 2, 3, 4]]
    np.testing.assert_array_equal(
        tio.ply.import_mesh(str(path), device="cpu").faces.numpy(),
        [[0, 1, 2], [1, 2, 3], [1, 3, 4]])


@pytest.mark.parametrize("header", ["OFF", "OFF-inline", "bare"])
@pytest.mark.parametrize("colors", ["255", "unit", "none"])
def test_off_import_matches_jax(header, colors, tmp_path):
    """OFF with face colours (0-255 and 0-1) and comments, its three
    header forms: as JAX's, with and without ``with_face_colors``; the
    export writes JAX's bytes."""
    v = RNG.rand(6, 3).astype(np.float32)
    f = RNG.randint(0, 6, (5, 3))
    scale = 255 if colors == "255" else 1
    lines = {"OFF": ["OFF", "6 5 0"], "OFF-inline": ["OFF 6 5 0"],
             "bare": ["6 5 0"]}[header]
    lines = ["# a comment"] + lines + [f"{a} {b} {c} # vertex"
                                       for a, b, c in v]
    for face in f:
        c = "" if colors == "none" else " " + " ".join(
            str(x) for x in (RNG.rand(3) * scale).round(3))
        lines.append("3 " + " ".join(map(str, face)) + c)
    path = _write(tmp_path / "m.off", "\n".join(lines) + "\n")
    for with_colors in (False, True):
        assert_meshes_equal(
            tio.off.import_mesh(path, with_face_colors=with_colors,
                                device="cpu"),
            jio.off.import_mesh(path, with_face_colors=with_colors))
    jio.off.export_mesh(tmp_path / "j.off", v, f)
    tio.off.export_mesh(tmp_path / "t.off", torch.from_numpy(v), f)
    assert (tmp_path / "t.off").read_bytes() == \
        (tmp_path / "j.off").read_bytes()


# -- the dispatcher and the asset ------------------------------------------
def test_dispatcher_matches_jax(tmp_path):
    """``io.import_mesh`` on OBJ (with its keywords), OFF, PLY, glTF, GLB
    and USD (``.usd``, ``.usda``, ``.usdc``) as JAX's; a ``.usdz`` (which
    JAX's dispatcher refuses) as JAX's ``io.usd.import_mesh`` reads it, and
    its gaussians as JAX's ``import_gaussiancloud``; an unknown extension
    ValueError."""
    _obj_textures(tmp_path)
    _write(tmp_path / "m.mtl", MTL)
    files = {"obj": _write(tmp_path / "a.obj", _obj_text("quads")),
             "ply": _ply_mesh_file(tmp_path / "a.ply", True, True, True),
             "gltf": _gltf_doc(tmp_path), "glb": _gltf_doc(tmp_path, True)}
    tio.off.export_mesh(tmp_path / "a.off", RNG.rand(4, 3).astype(
        np.float32), np.array([[0, 1, 2], [1, 2, 3]]))
    files["off"] = str(tmp_path / "a.off")
    for fmt, path in files.items():
        kw = dict(triangulate=True, with_materials=True) if fmt == "obj" \
            else dict(triangulate=True)
        assert_meshes_equal(tio.import_mesh(path, device="cpu", **kw),
                            jio.import_mesh(path, **kw), GLTF_RTOL,
                            ("vertices", "normals"))
    v, f = RNG.rand(6, 3).astype(np.float32), np.array([[0, 1, 2],
                                                         [3, 4, 5]])
    g = {"positions": RNG.randn(5, 3).astype(np.float32),
         "orientations": RNG.randn(5, 4).astype(np.float32),
         "scales": RNG.rand(5, 3).astype(np.float32),
         "opacities": RNG.rand(5).astype(np.float32),
         "sh_coeff": RNG.randn(5, 4, 3).astype(np.float32)}
    for ext in ("usd", "usda", "usdc"):
        path = str(tmp_path / f"a.{ext}")
        stage = jio.usd.create_stage(path)
        jio.usd.add_mesh(stage, "/World/a", v, f)
        jio.usd.add_gaussiancloud(stage, "/World/g", **g)
        stage.save()
        assert_meshes_equal(tio.import_mesh(path, device="cpu"),
                            jio.import_mesh(path))
    usdz = str(tmp_path / "a.usdz")
    with zipfile.ZipFile(usdz, "w", zipfile.ZIP_STORED) as z:
        z.write(str(tmp_path / "a.usdc"), "a.usdc")
    with pytest.raises(ValueError):
        jio.import_mesh(usdz)
    assert_meshes_equal(tio.import_mesh(usdz, device="cpu"),
                        jio.usd.import_mesh(usdz))
    got = tio.import_gaussiancloud(usdz, device="cpu")
    want = jio.import_gaussiancloud(usdz)
    for k in g:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    with pytest.raises(ValueError):
        tio.import_mesh(str(tmp_path / "a.stl"), device="cpu")


@pytest.fixture(scope="module")
def asset(tmp_path_factory):
    """``examples/torch_asset_render.py``'s asset at a small size, written
    once → (paths, the arrays written)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import torch_asset_render as ex
    finally:
        sys.path.pop(0)
    return ex, *ex.write_asset(str(tmp_path_factory.mktemp("asset")),
                               (16, 24), 32)


def test_asset_imports_equal_what_was_written(asset):
    """The example's four files: the OBJ, PLY and OFF imports equal the
    arrays written (the OBJ's materials equal ``obj_reference``'s); the
    GLB's face vertices, face UVs and normals within 1e-6 of max|x| (they
    pass through the node transforms and the v flip), its faces in the
    same order and its materials those written; each import equal to
    JAX's of the same file."""
    ex, paths, a = asset
    meshes = ex.import_asset(paths, "cpu")
    obj, ref = meshes["obj"], ex.obj_reference(a, "cpu")
    for name in ("vertices", "faces", "uvs", "face_uvs_idx",
                 "material_assignments"):
        assert_close(obj.get_attribute(name), ref.get_attribute(name))
    for got, want in zip(obj.materials, ref.materials):
        assert got.get_attributes() == want.get_attributes()
        for k in got.get_attributes(only_tensors=True):
            assert_close(getattr(got, k), getattr(want, k))
    for fmt in ("ply", "off"):
        assert_close(meshes[fmt].vertices, a["vertices"])
        assert_close(meshes[fmt].faces, a["faces"])
    assert_close(meshes["ply"].vertex_colors, (a["normals"] + 1.0) / 2.0)
    glb = meshes["glb"]
    assert_close(glb.face_vertices, a["vertices"][a["faces"]], GLTF_RTOL)
    assert_close(glb.face_uvs, a["uvs"][a["face_uvs_idx"]], GLTF_RTOL)
    n = host(glb.face_normals)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    assert_close(n, a["normals"][a["faces"]], GLTF_RTOL)
    assert_close(glb.material_assignments, a["material_assignments"])
    assert [m.material_name for m in glb.materials] == ["checker", "metal"]
    assert glb.materials[1].is_specular_workflow
    kw = {"obj": dict(with_materials=True, raw_materials=False)}
    meshes = ex.import_asset(paths, "cpu")    # nothing computed yet
    for fmt, path in paths.items():
        want = jio.import_mesh(path, **kw.get(fmt, {}))
        extra = ("uvs", "face_uvs_idx", "normals", "face_normals_idx") \
            if fmt == "glb" else ()
        assert_meshes_equal(meshes[fmt], want, GLTF_RTOL,
                            ("vertices", "normals"), extra=extra)
