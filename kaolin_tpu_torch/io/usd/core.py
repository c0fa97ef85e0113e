"""USD I/O via a self-contained USDA (text) reader and writer, with the
binary Crate container of :mod:`.crate` and :mod:`.crate_write`.

Counterpart of ``kaolin_tpu/io/usd/core.py``: the same subset of USD (Mesh,
Points, GeomSubset, ParticleField3DGaussianSplat and Shader prims,
time-sampled attributes for Timelapse checkpoints, the Kaolin physics
attributes), the same text, byte for byte: every number is written with
``:g`` (6 significant digits), as the JAX package writes it. Exporters take
tensors on any device or arrays and write from the host; importers return
tensors on ``device`` (the CUDA device unless named).

Departures from the JAX package (ROADMAP Queue C):

- the prim scan skips braces inside quoted strings and asset paths (F34),
  in one pass that jumps between the characters it looks at, instead of a
  per-character loop at each level;
- a binary layer's arrays reach the importers as arrays: the Crate reader
  puts a placeholder ``[<k>]`` in the text in their place (:func:`_stash`),
  where the JAX package prints every value as text and parses it back,
  with the same values;
- a value's text is formatted when a USDA file is saved, not when it is
  set, so a ``.usdc`` export never formats its arrays;
- ``get_mesh_prim_materials`` binds each subset to the material of its own
  name (F33); a point cloud's authored normals are read (F35); a binary
  layer's transform (F36) and its materials' colours and maps (F37) are
  read.
"""

import itertools
import os
import re
import weakref
from collections import namedtuple

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _host
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "UsdaStage", "create_stage", "add_mesh", "add_pointcloud",
    "add_voxelgrid", "export_mesh", "export_meshes", "export_pointcloud",
    "get_face_uvs_idx", "get_uvmap_primvar", "set_normals",
    "import_mesh", "import_meshes", "import_pointcloud",
]


def _fmt_vec_array(arr, per=3):
    arr = np.asarray(arr).reshape(-1, per)
    return "[" + ", ".join("(" + ", ".join(f"{x:g}" for x in row) + ")"
                           for row in arr) + "]"


def _fmt_int_array(arr):
    return "[" + ", ".join(str(int(x)) for x in np.asarray(arr).reshape(-1)) + "]"


def _fmt_float_array(arr):
    return "[" + ", ".join(f"{float(x):g}"
                           for x in np.asarray(arr).reshape(-1)) + "]"


def _snapshot(x):
    """A host copy of a tensor or an array (None stays None): a stage
    formats its text later, so it keeps values the caller cannot change."""
    return None if x is None else np.array(_host(x))


def _lazy(fmt, *args, **kwargs):
    """The text of a value, formatted when a USDA file needs it."""
    return lambda: fmt(*args, **kwargs)


def _on_device(x, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


class _Prim:
    def __init__(self, path, prim_type):
        self.path = path
        self.prim_type = prim_type
        self.attrs = {}        # name → (usd_type, value_string)
        self.time_samples = {}  # name → (usd_type, {time: value_string})
        self.raw = {}          # name → raw value (binary export, lossless)
        self.raw_ts = {}       # name → {time: raw value}

    def set_attr(self, name, usd_type, value, time=None, raw=None):
        """``raw`` (optional numpy/scalar) is kept alongside the formatted
        USDA string so the binary ``.usdc`` writer is lossless — the text
        formatting rounds to 6 significant digits. ``value`` may be a
        callable that formats the string when a USDA file is saved."""
        if time is None:
            self.attrs[name] = (usd_type, value)
            if raw is not None:
                self.raw[name] = raw
        else:
            self.time_samples.setdefault(name, (usd_type, {}))[1][time] = value
            if raw is not None:
                self.raw_ts.setdefault(name, {})[time] = raw

    def format_text(self):
        """Format every value still held as a callable, once."""
        for name, (usd_type, value) in self.attrs.items():
            if callable(value):
                self.attrs[name] = (usd_type, value())
        for _, samples in self.time_samples.values():
            for t, value in samples.items():
                if callable(value):
                    samples[t] = value()


class UsdaStage:
    """Minimal USD stage for authoring USDA files. Ref Usd.Stage usage in
    ``kaolin/io/usd/utils.py``."""

    def __init__(self, file_path, up_axis="Y"):
        self.file_path = os.fspath(file_path)
        self.up_axis = up_axis
        self.prims = {}

    def _get_prim(self, scene_path, prim_type):
        if scene_path not in self.prims:
            self.prims[scene_path] = _Prim(scene_path, prim_type)
        return self.prims[scene_path]

    def add_mesh(self, scene_path, vertices=None, faces=None, time=None,
                 uvs=None, face_uvs_idx=None):
        prim = self._get_prim(scene_path, "Mesh")
        vertices, faces, uvs, face_uvs_idx = map(
            _snapshot, (vertices, faces, uvs, face_uvs_idx))
        if faces is not None:
            counts = np.full(faces.shape[0], faces.shape[1])
            prim.set_attr("faceVertexCounts", "int[]",
                          _lazy(_fmt_int_array, counts), time, raw=counts)
            prim.set_attr("faceVertexIndices", "int[]",
                          _lazy(_fmt_int_array, faces), time,
                          raw=faces.reshape(-1))
        if vertices is not None:
            prim.set_attr("points", "point3f[]",
                          _lazy(_fmt_vec_array, vertices), time,
                          raw=vertices)
        if uvs is not None:
            prim.set_attr("primvars:st", "texCoord2f[]",
                          _lazy(_fmt_vec_array, uvs, per=2), time, raw=uvs)
        if face_uvs_idx is not None:
            prim.set_attr("primvars:st:indices", "int[]",
                          _lazy(_fmt_int_array, face_uvs_idx), time,
                          raw=face_uvs_idx.reshape(-1))
        return prim

    def add_pointcloud(self, scene_path, points, time=None, colors=None):
        prim = self._get_prim(scene_path, "Points")
        points, colors = _snapshot(points), _snapshot(colors)
        prim.set_attr("points", "point3f[]", _lazy(_fmt_vec_array, points),
                      time, raw=points)
        if colors is not None:
            prim.set_attr("primvars:displayColor", "color3f[]",
                          _lazy(_fmt_vec_array, colors), time, raw=colors)
        return prim

    def add_voxelgrid(self, scene_path, voxelgrid, time=None):
        """Store occupied voxel centers as a Points prim (the reference
        stores voxelgrids as PointInstancers; centers round-trip)."""
        vg = _host(voxelgrid)
        coords = np.stack(np.nonzero(vg), axis=-1).astype(np.float32)
        res = vg.shape[0]
        prim = self._get_prim(scene_path, "Points")
        prim.set_attr("points", "point3f[]",
                      _fmt_vec_array((coords + 0.5) / res), time)
        prim.set_attr("custom int grid_resolution", "int", str(res))
        return prim

    def save(self):
        """Write a properly NESTED prim tree: authored prims keep their type,
        intermediate path segments become Xforms, children (e.g. GeomSubsets
        under a Mesh) are emitted inside their parent's block.

        ``.usd`` / ``.usdc`` filenames save as the binary Crate container
        (ref ``io/usd/mesh.py:446`` exports binary via pxr; here via the
        dependency-free writer, round-trip-tested against the independent
        crate reader); anything else saves as USDA text."""
        ext = os.path.splitext(self.file_path)[1].lower()
        if ext in (".usd", ".usdc"):
            from kaolin_tpu_torch.io.usd.crate_write import write_usdc
            os.makedirs(os.path.dirname(os.path.abspath(self.file_path)),
                        exist_ok=True)
            write_usdc(self.file_path, self)
            return
        lines = ["#usda 1.0",
                 f'(\n    upAxis = "{self.up_axis}"\n)', ""]
        # trie of path segments
        tree = {}
        for path in self.prims:
            node = tree
            for part in [p for p in path.split("/") if p]:
                node = node.setdefault(part, {})

        def emit(node, path_prefix, indent):
            for part in sorted(node):
                path = path_prefix + "/" + part
                prim = self.prims.get(path)
                prim_type = prim.prim_type if prim is not None else "Xform"
                lines.append(f'{indent}def {prim_type} "{part}"')
                lines.append(indent + "{")
                inner = indent + "    "
                if prim is not None:
                    prim.format_text()
                    for name, (usd_type, value) in prim.attrs.items():
                        if usd_type == "int":
                            lines.append(f"{inner}{name} = {value}")
                        else:
                            lines.append(
                                f"{inner}{usd_type} {name} = {value}")
                    for name, (usd_type, samples) in \
                            prim.time_samples.items():
                        lines.append(
                            f"{inner}{usd_type} {name}.timeSamples = {{")
                        for t in sorted(samples):
                            lines.append(f"{inner}    {t}: {samples[t]},")
                        lines.append(f"{inner}}}")
                emit(node[part], path, inner)
                lines.append(indent + "}")

        emit(tree, "", "")
        lines.append("")
        os.makedirs(os.path.dirname(os.path.abspath(self.file_path)),
                    exist_ok=True)
        with open(self.file_path, "w") as f:
            f.write("\n".join(lines))


def create_stage(file_path, up_axis="Y"):
    """Ref ``io/usd/utils.py`` create_stage."""
    return UsdaStage(file_path, up_axis)


# ---------------- convenience API (ref usd/mesh.py, usd/pointcloud.py) -----

def add_mesh(stage, scene_path, vertices=None, faces=None, time=None, **kw):
    return stage.add_mesh(scene_path, vertices, faces, time=time, **kw)


def add_pointcloud(stage, scene_path, points, time=None, colors=None):
    return stage.add_pointcloud(scene_path, points, time=time, colors=colors)


def add_voxelgrid(stage, scene_path, voxelgrid, time=None):
    return stage.add_voxelgrid(scene_path, voxelgrid, time=time)


def export_mesh(file_path, scene_path="/World/mesh", vertices=None,
                faces=None, up_axis="Y", uvs=None, face_uvs_idx=None,
                time=None):
    """Write one mesh to a USDA file. Ref ``usd/mesh.py:733``."""
    stage = create_stage(file_path, up_axis)
    stage.add_mesh(scene_path, vertices, faces, time=time, uvs=uvs,
                   face_uvs_idx=face_uvs_idx)
    stage.save()


def export_meshes(file_path, scene_paths, vertices_list, faces_list,
                  up_axis="Y"):
    stage = create_stage(file_path, up_axis)
    for sp, v, f in zip(scene_paths, vertices_list, faces_list):
        stage.add_mesh(sp, v, f)
    stage.save()


def export_pointcloud(file_path, points, scene_path="/World/pointcloud",
                      colors=None):
    stage = create_stage(file_path)
    stage.add_pointcloud(scene_path, points, colors=colors)
    stage.save()


# ---------------- parsing ----------------

_PRIM_RE = re.compile(r'def\s+(\w+)\s+"([^"]+)"')
_VEC_RE = re.compile(r"\(([^)]*)\)")
# the characters that can start what the prim scan looks at: a prim header
# ("def ..."), a string or an asset path (whose braces do not count), a brace
_SCAN_RE = re.compile(r'[{}"@d]')
_STRING_RE = re.compile(r'"(?:[^"\\]|\\.)*"')

# arrays of binary layers, by the key of their placeholder "[<key>]" in the
# layer's text; each prim read from the layer holds them (its "_arrays")
_STASHED = weakref.WeakValueDictionary()
_KEYS = itertools.count()


def _stash(held):
    """A function that keeps an array and returns its placeholder text; the
    arrays it keeps are appended to ``held``, which keeps them alive."""
    def put(arr):
        key = next(_KEYS)
        _STASHED[key] = arr
        held.append(arr)
        return f"[<{key}>]"
    return put


def _stashed(text):
    """The array behind a placeholder, or None for text."""
    text = text.strip()
    if text.startswith("[<") and text.endswith(">]"):
        return _STASHED[int(text[2:-2])]
    return None


def _parse_vec_array(text, per=3):
    arr = _stashed(text)
    if arr is not None:
        # as its text would parse: a flat array holds no tuple
        flat = arr.reshape(-1) if arr.ndim == 2 else arr[:0]
        return flat.astype(np.float32).reshape(-1, per)
    vals = []
    for m in _VEC_RE.finditer(text):
        vals.append([float(x) for x in m.group(1).split(",")])
    return np.asarray(vals, dtype=np.float32).reshape(-1, per)


def _parse_int_array(text):
    arr = _stashed(text)
    if arr is not None:
        if arr.size and (arr.ndim == 2 or arr.dtype.kind == "f"):
            raise ValueError("not an int array")   # int("1.0") raises
        return arr.reshape(-1).astype(np.int64)
    inner = text[text.index("[") + 1:text.index("]")]
    if not inner.strip():
        return np.zeros((0,), dtype=np.int64)
    return np.asarray([int(x) for x in inner.split(",")], dtype=np.int64)


def _read_usd_text(file_path, stash=None):
    """Read any USD container (.usda text, binary .usdc crate, or .usdz
    zip package) as USDA text. Binary crate layers go through the
    dependency-free reader (:mod:`kaolin_tpu_torch.io.usd.crate`) and are
    transpiled to USDA (defaults + timeSamples), so every text-parsing
    import path handles all three containers; with ``stash``
    (:func:`_stash`) their numeric arrays stay arrays behind
    placeholders."""
    with open(file_path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"PXR-USDC"):
        from kaolin_tpu_torch.io.usd.crate import crate_to_usda
        return crate_to_usda(file_path, stash=stash)
    if head.startswith(b"PK\x03\x04"):
        import zipfile

        from kaolin_tpu_torch.io.usd.crate import crate_to_usda, is_crate
        with zipfile.ZipFile(file_path) as z:
            names = [n for n in z.namelist()
                     if n.lower().endswith((".usd", ".usdc", ".usda"))]
            if not names:
                raise ValueError(f"{file_path}: USDZ with no usd layer")
            data = z.read(names[0])
        if is_crate(data[:8]):
            return crate_to_usda(file_path, stash=stash, data=data)
        return data.decode("utf-8")
    with open(file_path) as f:
        return f.read()


def _scan_prims(src):
    """The prims of a layer's text in order, parents first: dicts
    {"type", "name", "path", "parent", "body"}, the body without nested
    prims. One pass that jumps from one character of interest to the next
    (a regular-expression search); braces inside strings and asset paths
    do not count (the JAX package's per-character scan, run again at each
    level, counts them, F34)."""
    prims = []
    open_prims = []   # [prim, depth of its body, start of body, first child]
    pending = None    # a header waiting for its "{"
    depth = pos = 0
    while True:
        m = _SCAN_RE.search(src, pos)
        if m is None:
            break
        c, pos = m.group(), m.end()
        if c == "d":
            head = _PRIM_RE.match(src, m.start())
            if head is None:
                continue
            if open_prims and open_prims[-1][3] is None:
                open_prims[-1][3] = m.start()
            if pending is None:
                pending = (head.group(1), head.group(2))
            pos = head.end()
        elif c == '"':
            text = _STRING_RE.match(src, m.start())
            if text is not None:
                pos = text.end()
        elif c == "@":
            end = src.find("@", pos)
            if end >= 0:
                pos = end + 1
        elif c == "{":
            depth += 1
            if pending is not None:
                parent = open_prims[-1][0]["path"] if open_prims else ""
                prim = {"type": pending[0], "name": pending[1],
                        "path": parent + "/" + pending[1],
                        "parent": parent or "/", "body": None}
                prims.append(prim)
                open_prims.append([prim, depth, pos, None])
                pending = None
        else:   # "}"
            if open_prims and open_prims[-1][1] == depth:
                prim, _, start, child = open_prims.pop()
                prim["body"] = src[start:m.start() if child is None
                                   else child]
            depth -= 1
    for prim, _, start, child in open_prims:   # unclosed: to the end
        prim["body"] = src[start:child]
    return prims


def _parse_usda(file_path):
    """Very small USDA parser: prim blocks with flat attributes and
    timeSamples. Returns a list of dicts with full hierarchy paths:
    {"type", "name", "path", "parent", "body"} (body excludes nested
    prims). Accepts all three USD containers via :func:`_read_usd_text`;
    a binary layer's prims also hold its arrays (``"_arrays"``)."""
    held = []
    prims = _scan_prims(_read_usd_text(file_path, _stash(held)))
    if held:
        for prim in prims:
            prim["_arrays"] = held
    return prims


def _block_end(text, start):
    """The index of the "}" that closes the "{" at ``start`` (every brace
    counts, as in the JAX package)."""
    depth = 0
    for m in re.compile(r"[{}]").finditer(text, start):
        depth += 1 if m.group() == "{" else -1
        if depth == 0:
            return m.start()
    return len(text) - 1


def _extract_attr(body, name):
    """Return (default_value_text, {time: text}) for an attribute."""
    samples = {}
    ts = re.search(rf"{re.escape(name)}\.timeSamples\s*=\s*{{", body)
    if ts:
        start = body.index("{", ts.start())
        inner = body[start + 1:_block_end(body, start)]
        for entry in re.finditer(r"([\d.]+)\s*:\s*(\[[^\]]*\])", inner):
            samples[float(entry.group(1))] = entry.group(2)
    m = re.search(rf"{re.escape(name)}\s*=\s*(\[[^\]]*\])", body)
    default = m.group(1) if m else None
    return default, samples


def _extract_interpolation(body, name):
    """The USDA ``( interpolation = "..." )`` metadata block following an
    attribute, or None."""
    m = re.search(
        re.escape(name)
        + r'\s*=\s*\[[^\]]*\]\s*\(\s*[^)]*interpolation\s*=\s*"(\w+)"',
        body)
    return m.group(1) if m else None


def get_face_uvs_idx(faces, face_sizes, uvs, uv_idx, uv_interpolation,
                     **kwargs):
    """Resolve USD uv primvar interpolation into per-face-vertex uv indices
    (ref ``usd/mesh.py:257``): 'vertex'/'varying' index uvs by the mesh
    vertex indices; 'faceVarying' enumerates one uv per face-vertex."""
    faces = np.asarray(faces)
    if uv_interpolation in ("vertex", "varying"):
        if uv_idx is None:
            if uvs is None:
                raise ValueError("Neither uvs nor uv_idx are set")
            uv_idx = np.arange(len(uvs))
        return np.asarray(uv_idx)[faces]
    if uv_interpolation == "faceVarying":
        if uv_idx is None:
            uv_idx = np.arange(int(np.sum(face_sizes)))
        return np.asarray(uv_idx)
    raise NotImplementedError(
        f"Interpolation type {uv_interpolation} is not supported")


def set_normals(geo):
    """Route raw USD normals into the right SurfaceMesh slot by their
    interpolation (ref ``usd/mesh.py:279``): 'faceVarying' → face_normals,
    'vertex' → vertex_normals."""
    normals_interpolation = geo.get("normals_interpolation")
    if normals_interpolation == "faceVarying":
        geo["face_normals"] = geo.get("normals")
    elif normals_interpolation == "vertex":
        geo["vertex_normals"] = geo.get("normals")
    else:
        raise NotImplementedError(
            f"Interpolation type {normals_interpolation} is not supported")


def _attr_text(body, name, time):
    default, samples = _extract_attr(body, name)
    if time is not None and samples:
        return samples[min(samples, key=lambda t: abs(t - time))]
    return default or next(iter(samples.values()), None)


def get_uvmap_primvar(body):
    """The uv primvar name of a mesh prim body, searched in the reference's
    priority order (ref ``usd/mesh.py:69``): ``primvars:st``, then any
    ``texCoord2f[]`` primvar, then ``primvars:UVMap`` (blender exports),
    then any ``float2[]`` primvar. Returns the primvar name or None."""
    if re.search(r"primvars:st\s*=", body):
        return "primvars:st"
    m = re.search(r"texCoord2f\[\]\s+(primvars:[\w:]+)\s*=", body)
    if m:
        return m.group(1)
    if re.search(r"primvars:UVMap\s*=", body):
        return "primvars:UVMap"
    m = re.search(r"float2\[\]\s+(primvars:[\w:]+)\s*=", body)
    if m:
        return m.group(1)
    return None


def import_meshes(file_path, scene_paths=None, time=None, with_normals=True,
                  with_uvs=True, device=None):
    """Mesh prims → list of SurfaceMesh (points, faces, uvs +
    face_uvs_idx and normals resolved per their primvar interpolation) on
    ``device`` (the CUDA device unless named). ``scene_paths`` restricts
    (and orders) the result to those prim paths — reference-shaped (ref
    ``usd/mesh.py:356`` takes scene_paths too). Ref ``usd/mesh.py:356``."""
    device = resolve_device(device, "usd.import_meshes")
    out = []
    out_paths = []
    wanted = None if scene_paths is None else list(scene_paths)
    for prim in _parse_usda(file_path):
        if prim["type"] != "Mesh":
            continue
        if wanted is not None and prim["path"] not in wanted:
            continue
        body = prim["body"]
        pts_text = _attr_text(body, "points", time)
        if pts_text is None:
            continue
        vertices = _parse_vec_array(pts_text)
        idx_val = _attr_text(body, "faceVertexIndices", None)
        counts_val = _attr_text(body, "faceVertexCounts", None)
        kwargs = dict(vertices=vertices)
        homogeneous = False
        counts = None
        if idx_val is not None and counts_val is not None:
            idx = _parse_int_array(idx_val)
            counts = _parse_int_array(counts_val)
            if counts.size and (counts == counts[0]).all():
                kwargs["faces"] = idx.reshape(-1, counts[0])
                homogeneous = True
            else:
                from kaolin_tpu_torch.io.utils import (
                    mesh_handler_naive_triangulate)
                v2, c2, idx2 = mesh_handler_naive_triangulate(
                    vertices, counts, idx)
                kwargs["vertices"] = np.asarray(v2)
                kwargs["faces"] = np.asarray(idx2).reshape(-1, 3)
        if homogeneous:
            fsz = int(counts[0])
            num_verts = np.asarray(kwargs["vertices"]).shape[0]
            num_fv = int(np.sum(counts))

            def _infer_interp(count):
                # no authored interpolation metadata: infer from the value
                # count (USD defaults vary by attribute; sizes are decisive)
                if count == num_verts:
                    return "vertex"
                if count == num_fv:
                    return "faceVarying"
                return None

            if with_uvs:
                uv_name = get_uvmap_primvar(body)
                uv_text = (_attr_text(body, uv_name, time)
                           if uv_name else None)
                if uv_text is not None:
                    uvs = _parse_vec_array(uv_text, per=2)
                    uvi_text = _attr_text(body, f"{uv_name}:indices", None)
                    uv_idx = (_parse_int_array(uvi_text)
                              if uvi_text is not None else None)
                    interp = _extract_interpolation(body, uv_name)
                    if interp is None:
                        interp = ("faceVarying" if uv_idx is not None
                                  else _infer_interp(len(uvs)))
                    kwargs["uvs"] = uvs
                    try:
                        if interp is None:
                            raise ValueError("ambiguous uv interpolation")
                        fuv_idx = get_face_uvs_idx(
                            np.asarray(kwargs["faces"]), counts, uvs, uv_idx,
                            interp)
                        kwargs["face_uvs_idx"] = np.asarray(
                            fuv_idx).reshape(-1, fsz)
                    except (NotImplementedError, ValueError):
                        pass
            if with_normals:
                n_text = _attr_text(body, "normals", time)
                if n_text is not None:
                    normals = _parse_vec_array(n_text)
                    interp = _extract_interpolation(body, "normals") \
                        or _infer_interp(len(normals))
                    geo = {"normals": normals,
                           "normals_interpolation": interp}
                    try:
                        set_normals(geo)
                        if "face_normals" in geo:
                            kwargs["face_normals"] = \
                                geo["face_normals"].reshape(-1, fsz, 3)
                        elif "vertex_normals" in geo:
                            kwargs["vertex_normals"] = \
                                geo["vertex_normals"]
                    except (NotImplementedError, ValueError):
                        pass
        out.append(SurfaceMesh(**{k: _on_device(v, device)
                                  for k, v in kwargs.items()},
                               strict_checks=False))
        out_paths.append(prim["path"])
    if wanted is not None:
        order = {p_: i for i, p_ in enumerate(out_paths)}
        missing = [p_ for p_ in wanted if p_ not in order]
        if missing:
            raise ValueError(f"no Mesh prim at {missing} in {file_path}")
        out = [out[order[p_]] for p_ in wanted]
    return out


def import_mesh(file_path, scene_path=None, time=None, device=None):
    """One Mesh prim → SurfaceMesh on ``device`` (the CUDA device unless
    named): the prim at ``scene_path`` when given, else the first Mesh in
    the stage. Ref ``usd/mesh.py:446``."""
    meshes = import_meshes(
        file_path, scene_paths=None if scene_path is None else [scene_path],
        time=time, device=device)
    if not meshes:
        raise ValueError(f"no Mesh prim in {file_path}")
    return meshes[0]


pointcloud_return_type = namedtuple(
    "pointcloud_return_type", ["points", "colors", "normals", "transform"])


def _read_points_prim(prim, time, device):
    """Points prim dict → pointcloud_return_type on ``device`` (ref
    usd/pointcloud.py:97, fields points/colors/normals/transform)."""
    default, samples = _extract_attr(prim["body"], "points")
    key = None
    if time is not None and samples:
        key = min(samples, key=lambda t: abs(t - time))
        text = samples[key]
    else:
        text = default or next(iter(samples.values()), None)
    if text is None:
        return None
    pts = _on_device(_parse_vec_array(text), device)

    def _aux(attr):
        d, s = _extract_attr(prim["body"], attr)
        t = d or (s.get(key) if key is not None and s else
                  next(iter(s.values()), None))
        return _on_device(_parse_vec_array(t), device) if t else None

    colors = _aux("primvars:displayColor")
    normals = _aux("normals")
    if normals is None:
        normals = _aux("primvars:normals")
    mat = _transform(prim["body"])
    transform = _on_device(mat, device) if mat is not None else None
    return pointcloud_return_type(pts, colors, normals, transform)


def import_pointcloud(file_path, scene_path=None, time=None, device=None):
    """Points prim → pointcloud_return_type(points, colors, normals,
    transform) on ``device`` (the CUDA device unless named),
    reference-shaped (ref usd/pointcloud.py:28,97). When ``scene_path`` is
    given only that prim matches; otherwise the first Points prim in the
    file."""
    device = resolve_device(device, "usd.import_pointcloud")
    for prim in _parse_usda(file_path):
        if prim["type"] != "Points":
            continue
        if scene_path is not None and prim["path"] != scene_path:
            continue
        out = _read_points_prim(prim, time, device)
        if out is not None:
            return out
    raise ValueError(f"no Points prim in {file_path}"
                     + (f" at {scene_path}" if scene_path else ""))


# ---------------- gaussian splats (ref usd/gaussians.py) ----------------

def add_gaussiancloud(stage, scene_path, positions, orientations, scales,
                      opacities, sh_coeff=None, local_to_world=None,
                      time=None):
    """Author a ``ParticleField3DGaussianSplat`` prim. Orientation input is
    (w, x, y, z); stored on disk as (x, y, z, w) quatf like the reference
    (``usd/gaussians.py:247``). sh_coeff is (N, S, 3), flattened on disk."""
    prim = stage._get_prim(scene_path, "ParticleField3DGaussianSplat")
    ori = _host(orientations).astype(np.float32)
    ori_xyzw = np.concatenate([ori[:, 1:], ori[:, :1]], axis=1)
    if sh_coeff is None:  # DC-only: grey splats (degree 0)
        sh_coeff = np.zeros((ori.shape[0], 1, 3), np.float32)
    sh = _host(sh_coeff).astype(np.float32)
    sh_degree = int(round(np.sqrt(sh.shape[1]))) - 1
    positions, scales = _snapshot(positions), _snapshot(scales)
    opacities = _snapshot(opacities).reshape(-1)
    prim.set_attr("positions", "point3f[]", _lazy(_fmt_vec_array, positions),
                  time, raw=positions)
    prim.set_attr("orientations", "quatf[]",
                  _lazy(_fmt_vec_array, ori_xyzw, per=4), time, raw=ori_xyzw)
    prim.set_attr("scales", "float3[]", _lazy(_fmt_vec_array, scales), time,
                  raw=scales)
    prim.set_attr("opacities", "float[]", _lazy(_fmt_float_array, opacities),
                  time, raw=opacities)
    prim.set_attr("radianceSphericalHarmonicsDegree", "int", str(sh_degree),
                  raw=sh_degree)
    prim.set_attr("radianceSphericalHarmonicsCoefficients", "float3[]",
                  _lazy(_fmt_vec_array, sh.reshape(-1, 3)), time,
                  raw=sh.reshape(-1, 3))
    if local_to_world is not None:
        mat = _host(local_to_world).astype(np.float64)
        rows = ", ".join("(" + ", ".join(f"{x:g}" for x in r) + ")"
                         for r in mat)
        prim.set_attr("xformOp:transform", "matrix4d", f"( {rows} )", time)
    return prim


def export_gaussiancloud(file_path, positions, orientations, scales,
                         opacities, sh_coeff=None,
                         scene_path="/World/Gaussians/gaussian_0",
                         local_to_world=None, time=None, up_axis="Y"):
    """Write a gaussian cloud USDA. Ref ``usd/gaussians.py:290``."""
    stage = create_stage(file_path, up_axis)
    add_gaussiancloud(stage, scene_path, positions, orientations, scales,
                      opacities, sh_coeff, local_to_world=local_to_world,
                      time=time)
    stage.save()


def _parse_float_array(text):
    arr = _stashed(text)
    if arr is not None:
        if arr.size and arr.ndim == 2:
            raise ValueError("not a flat array")   # float("(1") raises
        return arr.reshape(-1).astype(np.float32)
    inner = text[text.index("[") + 1:text.index("]")]
    if not inner.strip():
        return np.zeros((0,), dtype=np.float32)
    return np.asarray([float(x) for x in inner.split(",")], dtype=np.float32)


def import_gaussianclouds(file_path, scene_path=None, time=None,
                          device=None):
    """All ParticleField3DGaussianSplat prims → list of GaussianSplatModel
    on ``device`` (the CUDA device unless named). Ref
    ``usd/gaussians.py:83``."""
    from kaolin_tpu_torch.rep.gaussians import GaussianSplatModel
    device = resolve_device(device, "usd.import_gaussianclouds")

    def pick(body, name, vec=True, per=3):
        default, samples = _extract_attr(body, name)
        if time is not None and samples:
            key = min(samples, key=lambda t: abs(t - time))
            text = samples[key]
        else:
            text = default or next(iter(samples.values()), None)
        if text is None:
            return None
        return (_parse_vec_array(text, per=per) if vec
                else _parse_float_array(text))

    out = []
    for prim in _parse_usda(file_path):
        if prim["type"] != "ParticleField3DGaussianSplat":
            continue
        if scene_path is not None and scene_path.split("/")[-1] \
                not in (prim["name"],):
            continue
        body = prim["body"]
        positions = pick(body, "positions")
        ori_xyzw = pick(body, "orientations", per=4)
        orientations = np.concatenate(
            [ori_xyzw[:, 3:], ori_xyzw[:, :3]], axis=1)
        scales = pick(body, "scales")
        opacities = pick(body, "opacities", vec=False)
        sh_flat = pick(body, "radianceSphericalHarmonicsCoefficients")
        sh = sh_flat.reshape(positions.shape[0], -1, 3)
        out.append(GaussianSplatModel(
            positions=_on_device(positions, device),
            orientations=_on_device(orientations, device),
            scales=_on_device(scales, device),
            opacities=_on_device(opacities, device),
            sh_coeff=_on_device(sh, device), strict_checks=False))
    return out


def import_gaussiancloud(file_path, scene_path=None, time=None,
                         device=None):
    """First (or merged) gaussian cloud → GaussianSplatModel on ``device``
    (the CUDA device unless named) or None. Ref ``usd/gaussians.py:134``."""
    from kaolin_tpu_torch.rep.gaussians import GaussianSplatModel
    clouds = import_gaussianclouds(file_path, scene_path, time, device)
    if not clouds:
        return None
    if len(clouds) == 1:
        return clouds[0]
    return GaussianSplatModel.cat(clouds)


def import_voxelgrid(file_path, scene_path=None, time=None, device=None):
    """Points prim with grid_resolution → dense bool grid on ``device``
    (the CUDA device unless named)."""
    device = resolve_device(device, "usd.import_voxelgrid")
    for prim in _parse_usda(file_path):
        if prim["type"] != "Points":
            continue
        body = prim["body"]
        m = re.search(r"grid_resolution\s*=\s*(\d+)", body)
        if not m:
            continue
        res = int(m.group(1))
        default, samples = _extract_attr(body, "points")
        if time is not None and samples:
            key = min(samples, key=lambda t: abs(t - time))
            text = samples[key]
        else:
            text = default or next(iter(samples.values()), None)
        centers = _parse_vec_array(text)
        coords = np.clip((centers * res - 0.5).round().astype(np.int64),
                         0, res - 1)
        grid = np.zeros((res, res, res), dtype=bool)
        grid[coords[:, 0], coords[:, 1], coords[:, 2]] = True
        return _on_device(grid, device)
    raise ValueError(f"no voxelgrid Points prim in {file_path}")


# -------- physics materials (ref usd/physics_materials.py, custom schema) ---

def add_physics_material(stage, scene_path, physics_points,
                         material_name="default", time=None):
    """Persist PhysicsPoints as KaolinPhysicsMaterialAPI attributes
    (ref ``usd/physics_materials.py:35``, schema ``custom_schema``:38)."""
    prim = stage._get_prim(scene_path, "Xform")
    ns = f"kaolin_physics_material:{material_name}"
    pts = _snapshot(physics_points.pts)
    prim.set_attr(f"{ns}:pts", "point3f[]", _lazy(_fmt_vec_array, pts), time,
                  raw=pts)
    for name in ("yms", "prs", "rhos"):
        arr = _snapshot(getattr(physics_points, name)).reshape(-1)
        prim.set_attr(f"{ns}:{name}", "float[]",
                      _lazy(_fmt_float_array, arr), time, raw=arr)
    prim.set_attr(f"{ns}:appx_vol", "float",
                  f"{float(physics_points.appx_vol):g}", time,
                  raw=float(physics_points.appx_vol))
    return prim


def add_skinned_physics(stage, scene_path, skinned_physics_points,
                        instance_name="default", time=None):
    """Persist SkinnedPhysicsPoints as KaolinSkinnedPhysicsAPI attributes
    (ref ``usd/physics_materials.py:102``, schema :66)."""
    prim = add_physics_material(stage, scene_path, skinned_physics_points,
                                material_name=instance_name, time=time)
    ns = f"kaolin_physics_material:{instance_name}"
    sw = _snapshot(skinned_physics_points.skinning_weights)
    dw = _snapshot(skinned_physics_points.dwdx)
    prim.set_attr(f"{ns}:num_handles", "int", str(sw.shape[1]),
                  raw=int(sw.shape[1]))
    prim.set_attr(f"{ns}:skinning_weights", "float[]",
                  _lazy(_fmt_float_array, sw), time, raw=sw.reshape(-1))
    prim.set_attr(f"{ns}:dwdx", "float[]", _lazy(_fmt_float_array, dw),
                  time, raw=dw.reshape(-1))
    if skinned_physics_points.renderable is not None:
        rend = skinned_physics_points.renderable
        rpts = _snapshot(rend.pts)
        rsw = _snapshot(rend.skinning_weights).reshape(-1)
        prim.set_attr(f"{ns}:renderable_pts", "point3f[]",
                      _lazy(_fmt_vec_array, rpts), time, raw=rpts)
        prim.set_attr(f"{ns}:renderable_skinning_weights", "float[]",
                      _lazy(_fmt_float_array, rsw), time, raw=rsw)
    return prim


def get_physics_material(file_path, scene_path=None, material_name="default",
                         device=None):
    """Read back a PhysicsPoints on ``device`` (the CUDA device unless
    named). Ref ``usd/physics_materials.py:173``."""
    from kaolin_tpu_torch.physics.simplicits.training import PhysicsPoints
    device = resolve_device(device, "usd.get_physics_material")
    ns = f"kaolin_physics_material:{material_name}"
    for prim in _parse_usda(file_path):
        body = prim["body"]
        if f"{ns}:pts" not in body:
            continue
        pts = _parse_vec_array(_extract_attr(body, f"{ns}:pts")[0])
        fields = {}
        for name in ("yms", "prs", "rhos"):
            fields[name] = _parse_float_array(
                _extract_attr(body, f"{ns}:{name}")[0])
        m = re.search(rf"{re.escape(ns)}:appx_vol\s*=\s*([\d.eE+-]+)", body)
        return PhysicsPoints(pts=_on_device(pts, device), yms=fields["yms"],
                             prs=fields["prs"], rhos=fields["rhos"],
                             appx_vol=float(m.group(1)))
    raise ValueError(f"no physics material '{material_name}' in {file_path}")


def get_skinned_physics(file_path, scene_path=None, instance_name="default",
                        device=None):
    """Read back a SkinnedPhysicsPoints on ``device`` (the CUDA device
    unless named). Ref :247."""
    from kaolin_tpu_torch.physics.simplicits.training import (
        SkinnedPhysicsPoints, SkinnedPoints)
    device = resolve_device(device, "usd.get_skinned_physics")
    ns = f"kaolin_physics_material:{instance_name}"
    for prim in _parse_usda(file_path):
        body = prim["body"]
        if f"{ns}:skinning_weights" not in body:
            continue
        pts = _parse_vec_array(_extract_attr(body, f"{ns}:pts")[0])
        n = pts.shape[0]
        m = re.search(rf"{re.escape(ns)}:num_handles\s*=\s*(\d+)", body)
        h = int(m.group(1))
        fields = {}
        for name in ("yms", "prs", "rhos"):
            fields[name] = _parse_float_array(
                _extract_attr(body, f"{ns}:{name}")[0])
        sw = _parse_float_array(
            _extract_attr(body, f"{ns}:skinning_weights")[0]).reshape(n, h)
        dw = _parse_float_array(
            _extract_attr(body, f"{ns}:dwdx")[0]).reshape(n, h, 3)
        mv = re.search(rf"{re.escape(ns)}:appx_vol\s*=\s*([\d.eE+-]+)", body)
        renderable = None
        rp_text = _extract_attr(body, f"{ns}:renderable_pts")[0]
        if rp_text:
            rpts = _parse_vec_array(rp_text)
            rsw = _parse_float_array(_extract_attr(
                body, f"{ns}:renderable_skinning_weights")[0]) \
                .reshape(rpts.shape[0], h)
            renderable = SkinnedPoints(_on_device(rpts, device),
                                       _on_device(rsw, device))
        return SkinnedPhysicsPoints(
            pts=_on_device(pts, device), yms=fields["yms"],
            prs=fields["prs"], rhos=fields["rhos"],
            appx_vol=float(mv.group(1)),
            skinning_weights=_on_device(sw, device),
            dwdx=_on_device(dw, device), renderable=renderable)
    raise ValueError(f"no skinned physics '{instance_name}' in {file_path}")


__all__ += [
    "add_gaussiancloud", "export_gaussiancloud", "import_gaussiancloud",
    "import_gaussianclouds", "import_voxelgrid", "add_physics_material",
    "add_skinned_physics", "get_physics_material", "get_skinned_physics",
]


# ---------------- scene queries (ref usd/utils.py) ----------------

def get_scene_paths(file_path, scene_path_regex=None, prim_types=None):
    """All prim scene paths, optionally filtered by regex / prim types.
    Ref ``usd/utils.py:52``. (The lightweight USDA parser tracks prim names
    flat, so paths are '/<name>' unless authored nested.)"""
    if prim_types is not None and isinstance(prim_types, str):
        prim_types = [prim_types]
    out = []
    for prim in _parse_usda(file_path):
        if prim_types is not None and prim["type"] not in prim_types:
            continue
        path = prim["path"]
        if scene_path_regex is not None \
                and re.search(scene_path_regex, path) is None:
            continue
        out.append(path)
    return out


def get_mesh_scene_paths(file_path, scene_path_regex=None):
    """Ref ``usd/mesh.py:49``."""
    return get_scene_paths(file_path, scene_path_regex, prim_types=["Mesh"])


def get_pointcloud_scene_paths(file_path, scene_path_regex=None):
    """Ref ``usd/pointcloud.py:49``."""
    return get_scene_paths(file_path, scene_path_regex,
                           prim_types=["Points", "PointInstancer"])


def get_gaussiancloud_scene_paths(file_path, scene_path=None):
    """Ref ``usd/gaussians.py:164``."""
    regex = f"{re.escape(scene_path)}(/|$)" if scene_path else None
    return get_scene_paths(file_path, regex,
                           prim_types=["ParticleField3DGaussianSplat"])


def get_authored_time_samples(file_path):
    """Union of all authored timeSamples keys. Ref ``usd/utils.py:97``."""
    times = set()
    src = _read_usd_text(file_path, _stash([]))   # the times alone
    for m in re.finditer(r"^\s*([\d.]+)\s*:", src, re.MULTILINE):
        times.add(float(m.group(1)))
    return sorted(times)


def get_pointcloud_bracketing_time_samples(file_path, scene_path,
                                           target_time):
    """Two samples bracketing target_time for the first Points prim.
    Ref ``usd/pointcloud.py:72``."""
    for prim in _parse_usda(file_path):
        if prim["type"] != "Points":
            continue
        _, samples = _extract_attr(prim["body"], "points")
        if not samples:
            return [target_time, target_time]
        times = sorted(samples)
        lo = max([t for t in times if t <= target_time], default=times[0])
        hi = min([t for t in times if t >= target_time], default=times[-1])
        return [lo, hi]
    raise ValueError(f"no Points prim in {file_path}")


# ---------------- plural import/export ----------------

def export_pointclouds(file_path, pointclouds, scene_paths=None, colors=None,
                       up_axis="Y"):
    """Ref ``usd/pointcloud.py:421``."""
    stage = create_stage(file_path, up_axis)
    if scene_paths is None:
        scene_paths = [f"/World/pointcloud_{i}"
                       for i in range(len(pointclouds))]
    for i, (sp, pts) in enumerate(zip(scene_paths, pointclouds)):
        stage.add_pointcloud(
            sp, pts, colors=None if colors is None else colors[i])
    stage.save()


def import_pointclouds(file_path, scene_paths=None, times=None,
                       device=None):
    """All (or selected) Points prims → list of pointcloud_return_type on
    ``device`` (the CUDA device unless named), reference-shaped (ref
    usd/pointcloud.py:147, return_list=True)."""
    device = resolve_device(device, "usd.import_pointclouds")
    out = []
    i = 0
    for prim in _parse_usda(file_path):
        if prim["type"] != "Points":
            continue
        if scene_paths is not None and prim["path"] not in scene_paths:
            continue
        time = None
        if times is not None:
            time = times[i] if i < len(times) else times[-1]
        cloud = _read_points_prim(prim, time, device)
        if cloud is not None:
            out.append(cloud)
            i += 1
    return out


def export_voxelgrid(file_path, voxelgrid, scene_path="/World/voxelgrid",
                     up_axis="Y"):
    """Ref ``usd/voxelgrid.py:197``."""
    stage = create_stage(file_path, up_axis)
    stage.add_voxelgrid(scene_path, voxelgrid)
    stage.save()


def export_voxelgrids(file_path, voxelgrids, scene_paths=None, up_axis="Y"):
    """Ref :225."""
    stage = create_stage(file_path, up_axis)
    if scene_paths is None:
        scene_paths = [f"/World/voxelgrid_{i}"
                       for i in range(len(voxelgrids))]
    for sp, vg in zip(scene_paths, voxelgrids):
        stage.add_voxelgrid(sp, vg)
    stage.save()


def import_voxelgrids(file_path, scene_paths=None, times=None, device=None):
    """All voxelgrid prims → list of dense bool grids on ``device`` (the
    CUDA device unless named). Ref :63."""
    device = resolve_device(device, "usd.import_voxelgrids")
    out = []
    for prim in _parse_usda(file_path):
        if prim["type"] != "Points":
            continue
        m = re.search(r"grid_resolution\s*=\s*(\d+)", prim["body"])
        if not m:
            continue
        res = int(m.group(1))
        default, samples = _extract_attr(prim["body"], "points")
        text = default or next(iter(samples.values()), None)
        centers = _parse_vec_array(text)
        coords = np.clip((centers * res - 0.5).round().astype(np.int64),
                         0, res - 1)
        grid = np.zeros((res, res, res), dtype=bool)
        grid[coords[:, 0], coords[:, 1], coords[:, 2]] = True
        out.append(_on_device(grid, device))
    return out


# -------- UsdPreviewSurface materials (ref usd/materials.py:400,487) --------

# PBRMaterial attribute → (usd input name, usd type)
_PREVIEW_SURFACE_INPUTS = {
    "diffuse_color": ("diffuseColor", "color3f"),
    "roughness_value": ("roughness", "float"),
    "metallic_value": ("metallic", "float"),
    "specular_color": ("specularColor", "color3f"),
    "opacity_value": ("opacity", "float"),
    "ior_value": ("ior", "float"),
    "clearcoat_value": ("clearcoat", "float"),
    "clearcoat_roughness_value": ("clearcoatRoughness", "float"),
}
_TEXTURE_INPUTS = {
    "diffuse": "diffuseColor", "roughness": "roughness",
    "metallic": "metallic", "normals": "normal",
}


def write_usd_preview_surface(pbr_material, stage, scene_path,
                              write_texture_by_basename_fn=None, time=None):
    """Author a UsdPreviewSurface Shader prim from a PBRMaterial; textures
    are written via the exporter callable and referenced by relative path.
    Ref ``usd/materials.py:487``."""
    prim = stage._get_prim(scene_path + "/Shader", "Shader")
    prim.set_attr("info:id", "token", '"UsdPreviewSurface"')

    def set_scalar(name, usd_type, value):
        v = _host(value).reshape(-1)
        if usd_type == "color3f":
            prim.set_attr(f"inputs:{name}", "color3f",
                          "(" + ", ".join(f"{x:g}" for x in v) + ")", time)
        else:
            prim.set_attr(f"inputs:{name}", "float", f"{float(v[0]):g}",
                          time)

    for attr, (usd_name, usd_type) in _PREVIEW_SURFACE_INPUTS.items():
        value = getattr(pbr_material, attr, None)
        if value is not None:
            set_scalar(usd_name, usd_type, value)
    prim.set_attr("inputs:useSpecularWorkflow", "int",
                  str(int(bool(getattr(pbr_material, "is_specular_workflow",
                                       False)))))
    if write_texture_by_basename_fn is not None:
        for attr, usd_name in _TEXTURE_INPUTS.items():
            tex = getattr(pbr_material, attr + "_texture", None)
            if tex is not None:
                rel = write_texture_by_basename_fn(_host(tex), attr)
                prim.set_attr(f"inputs:{usd_name}:file", "asset",
                              f'@{rel}@', time)
    return prim


def read_usd_preview_surface(file_path, scene_path=None, time=None,
                             texture_root=None, device=None):
    """Parse a UsdPreviewSurface Shader prim → PBRMaterial, its values and
    textures (HWC, as read) on ``device`` (the CUDA device unless named).
    Ref :400.

    A binary layer's text holds a colour as an array and a texture's file
    as a quoted string; both are read here (the JAX package reads only the
    tuple and ``@asset@`` forms, so a ``.usdc`` material loses its colours
    and maps there, F37)."""
    import os as _os

    from kaolin_tpu_torch.io.utils import read_image
    from kaolin_tpu_torch.render.materials import PBRMaterial
    device = resolve_device(device, "usd.read_usd_preview_surface")
    if texture_root is None:
        texture_root = _os.path.dirname(_os.path.abspath(file_path))
    inv_inputs = {v[0]: (k, v[1]) for k, v in _PREVIEW_SURFACE_INPUTS.items()}
    inv_tex = {v: k for k, v in _TEXTURE_INPUTS.items()}
    for prim in _parse_usda(file_path):
        if prim["type"] != "Shader":
            continue
        if scene_path is not None:
            # match the prim path (or a Shader child under it — the
            # standard Material/Shader layout); a bare leaf name also works
            path = prim.get("path", "")
            if not (path == scene_path
                    or path.startswith(scene_path + "/")
                    or prim["name"] == scene_path.split("/")[-1]):
                continue
        body = prim["body"]
        # only surface shaders — a Material may also hold UsdUVTexture /
        # primvar-reader Shader prims (ref :400 reads the surface output)
        id_m = re.search(r'info:id\s*=\s*"([^"]+)"', body)
        if id_m and id_m.group(1) != "UsdPreviewSurface":
            continue
        params = {}
        for usd_name, (attr, usd_type) in inv_inputs.items():
            if usd_type == "color3f":
                m = re.search(
                    rf"inputs:{usd_name}\s*=\s*\(([^)]*)\)", body)
                if m:
                    params[attr] = torch.tensor(
                        [float(x) for x in m.group(1).split(",")],
                        dtype=torch.float32, device=device)
                m = re.search(
                    rf"inputs:{usd_name}\s*=\s*(\[[^\]]*\])", body)
                if m:
                    params[attr] = _on_device(_parse_float_array(m.group(1)),
                                              device)
            else:
                m = re.search(
                    rf"inputs:{usd_name}\s*=\s*([-\d.eE+]+)", body)
                if m:
                    params[attr] = torch.tensor(
                        [float(m.group(1))], dtype=torch.float32,
                        device=device)
        m = re.search(r"inputs:useSpecularWorkflow\s*=\s*(\d+)", body)
        if m:
            params["is_specular_workflow"] = bool(int(m.group(1)))
        for usd_name, attr in inv_tex.items():
            m = re.search(rf"inputs:{usd_name}:file\s*=\s*(?:@([^@]*)@"
                          rf'|"([^"]*)")', body)
            if m:
                params[attr + "_texture"] = read_image(
                    _os.path.join(texture_root, m.group(1) or m.group(2)),
                    device=device)
        return PBRMaterial(**params)
    raise ValueError(f"no Shader prim in {file_path}")


__all__ += [
    "get_scene_paths", "get_mesh_scene_paths", "get_pointcloud_scene_paths",
    "get_gaussiancloud_scene_paths", "get_authored_time_samples",
    "get_pointcloud_bracketing_time_samples", "export_pointclouds",
    "import_pointclouds", "export_voxelgrid", "export_voxelgrids",
    "import_voxelgrids", "write_usd_preview_surface",
    "read_usd_preview_surface",
]


# ---------------- GeomSubsets (ref usd/subset.py:26,125) ----------------

def add_subset(stage, prim_path, name, indices, family_name="part",
               element_type="face"):
    """Author a UsdGeomSubset child of ``prim_path``. Ref :26."""
    prim = stage._get_prim(f"{prim_path}/{name}", "GeomSubset")
    prim.set_attr("elementType", "uniform token", f'"{element_type}"')
    prim.set_attr("familyName", "uniform token", f'"{family_name}"')
    prim.set_attr("indices", "int[]", _fmt_int_array(_host(indices)))
    return prim


def import_subsets(file_path, prim_path=None, family_name=None,
                   device=None):
    """GeomSubsets of a prim → dict subset name → {"indices", "family_name"}
    (reference shape, ref usd/subset.py:125-145, keyed by name rather than
    full USD path since this backend authors flat hierarchies); the indices
    on ``device`` (the CUDA device unless named)."""
    device = resolve_device(device, "usd.import_subsets")
    out = {}
    for prim in _parse_usda(file_path):
        if prim["type"] != "GeomSubset":
            continue
        if prim_path is not None and prim["parent"] != prim_path:
            continue
        body = prim["body"]
        fam = re.search(r'familyName\s*=\s*"([^"]*)"', body)
        fam = fam.group(1) if fam else "part"
        if family_name is not None and fam != family_name:
            continue
        m = re.search(r"indices\s*=\s*(\[[^\]]*\])", body)
        out[prim["name"]] = {
            "indices": _on_device(_parse_int_array(m.group(1)), device),
            "family_name": fam,
        }
    return out


__all__ += ["add_subset", "import_subsets"]


# -------- remaining reference usd API (utils/materials/physics queries) -----

def set_local_to_world_transform(stage, scene_path, transform, time=None):
    """Author xformOp:transform on a prim. Ref ``usd/utils.py:30``."""
    prim = stage.prims.get(scene_path)
    if prim is None:
        prim = stage._get_prim(scene_path, "Xform")
    mat = _host(transform).astype(np.float64)
    rows = ", ".join("(" + ", ".join(f"{x:g}" for x in r) + ")" for r in mat)
    prim.set_attr("xformOp:transform", "matrix4d", f"( {rows} )", time)
    return prim


def _transform(body):
    """An authored ``xformOp:transform`` → (4, 4) float32, or None: the
    USDA tuple form, or the flat array of 16 that a binary layer's text
    holds (which the JAX package misses, reading identity, F36)."""
    m = re.search(r"xformOp:transform\s*=\s*\(\s*(\(.*\))\s*\)", body,
                  re.DOTALL)
    if m:
        return _parse_vec_array(m.group(1), per=4).reshape(4, 4)
    m = re.search(r"xformOp:transform\s*=\s*(\[[^\]]*\])", body)
    return _parse_float_array(m.group(1)).reshape(4, 4) if m else None


def get_local_to_world_transform(file_path, scene_path, time=None,
                                 device=None):
    """Read a prim's local-to-world matrix (identity if unauthored; this
    backend authors flat transforms) on ``device`` (the CUDA device unless
    named). Ref ``usd/utils.py:77``."""
    device = resolve_device(device, "usd.get_local_to_world_transform")
    name = scene_path.split("/")[-1]
    for prim in _parse_usda(file_path):
        if prim["name"] != name and prim["path"] != scene_path:
            continue
        mat = _transform(prim["body"])
        if mat is None:
            break
        return _on_device(mat, device)
    return torch.eye(4, device=device)


def export_material(pbr_material, file_path,
                    scene_path="/World/Looks/material", texture_dir=None):
    """Write a PBRMaterial as a UsdPreviewSurface USDA. Ref
    ``usd/materials.py:85``."""
    import os as _os

    from kaolin_tpu_torch.io.utils import TextureExporter
    stage = create_stage(file_path)
    exporter = TextureExporter(
        texture_dir or _os.path.dirname(_os.path.abspath(file_path)))
    write_usd_preview_surface(pbr_material, stage, scene_path, exporter)
    stage.save()


def import_material(file_path, scene_path=None, time=None, device=None):
    """Read a UsdPreviewSurface material → PBRMaterial on ``device`` (the
    CUDA device unless named). Ref ``usd/materials.py:46``."""
    return read_usd_preview_surface(file_path, scene_path, time,
                                    device=device)


def get_mesh_prim_materials(file_path, scene_path=None, time=None,
                            device=None):
    """Materials bound to a mesh's GeomSubsets (family 'materialBind') →
    dict subset name → PBRMaterial on ``device`` (parsed from Shader prims
    in the same file). Ref ``usd/materials.py:200``.

    Each subset takes the material of its own name: the surface shader
    under the prim so named (``/World/Looks/<subset>/Shader``, as
    ``write_usd_preview_surface`` lays it out). Where no prim of that name
    holds a Shader, it takes the file's first, as the JAX package gives
    every subset (F33)."""
    out = {}
    subsets = import_subsets(file_path, scene_path, device=device)
    holders = sorted({prim["parent"] for prim in _parse_usda(file_path)
                      if prim["type"] == "Shader"})
    for name, info in subsets.items():
        if info["family_name"] != "materialBind":
            continue
        own = [p for p in holders if p.rsplit("/", 1)[-1] == name]
        try:
            out[name] = read_usd_preview_surface(
                file_path, own[0] if own else None, device=device)
        except ValueError:
            out[name] = None
    return out


def get_raw_mesh_prim_geometry(file_path, scene_path=None, time=None,
                               with_normals=False, with_uvs=False,
                               device=None):
    """Raw (un-triangulated) mesh arrays on ``device`` (the CUDA device
    unless named): points, faceVertexCounts, faceVertexIndices (+
    normals/uvs when present). Ref ``usd/mesh.py:102``."""
    device = resolve_device(device, "usd.get_raw_mesh_prim_geometry")
    for prim in _parse_usda(file_path):
        if prim["type"] != "Mesh":
            continue
        if scene_path is not None and prim["path"] != scene_path \
                and prim["name"] != scene_path.split("/")[-1]:
            continue
        body = prim["body"]

        def pick(name, parser, per=3):
            default, samples = _extract_attr(body, name)
            if time is not None and samples:
                key = min(samples, key=lambda t: abs(t - time))
                text = samples[key]
            else:
                text = default or next(iter(samples.values()), None)
            if text is None:
                return None
            return parser(text) if parser is _parse_int_array \
                else parser(text, per)

        out = {
            "points": _on_device(pick("points", _parse_vec_array), device),
            "face_vertex_counts": _on_device(
                pick("faceVertexCounts", _parse_int_array), device),
            "face_vertex_indices": _on_device(
                pick("faceVertexIndices", _parse_int_array), device),
        }
        if with_normals:
            n = pick("normals", _parse_vec_array)
            out["normals"] = _on_device(n, device) if n is not None else None
        if with_uvs:
            u = pick("primvars:st", _parse_vec_array, per=2)
            out["uvs"] = _on_device(u, device) if u is not None else None
        return out
    raise ValueError(f"no Mesh prim in {file_path}")


def _physics_instance_names(file_path, needle):
    names = set()
    for prim in _parse_usda(file_path):
        for m in re.finditer(
                r"kaolin_physics_material:([\w\-]+):" + needle,
                prim["body"]):
            names.add(m.group(1))
    return sorted(names)


def get_physics_materials_instance_names(file_path, scene_path=None):
    """Ref ``usd/physics_materials.py:311``."""
    return _physics_instance_names(file_path, "pts")


def get_skinned_physics_instance_names(file_path, scene_path=None):
    """Ref :334."""
    return _physics_instance_names(file_path, "skinning_weights")


def get_all_physics_materials(file_path, scene_path=None, time=None,
                              device=None):
    """dict instance name → PhysicsPoints on ``device``. Ref :358."""
    return {name: get_physics_material(file_path, scene_path, name, device)
            for name in get_physics_materials_instance_names(file_path)}


def get_all_skinned_physics(file_path, scene_path=None, time=None,
                            device=None):
    """dict instance name → SkinnedPhysicsPoints on ``device``. Ref :391."""
    return {name: get_skinned_physics(file_path, scene_path, name, device)
            for name in get_skinned_physics_instance_names(file_path)}


__all__ += [
    "set_local_to_world_transform", "get_local_to_world_transform",
    "export_material", "import_material", "get_mesh_prim_materials",
    "get_raw_mesh_prim_geometry", "get_physics_materials_instance_names",
    "get_skinned_physics_instance_names", "get_all_physics_materials",
    "get_all_skinned_physics",
]
