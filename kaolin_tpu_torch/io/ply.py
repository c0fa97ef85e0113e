"""PLY import/export — meshes, point clouds and 3D gaussian splats.

Counterpart of ``kaolin_tpu/io/ply.py``: a parser of ASCII and binary
little-endian PLY with no plyfile dependency. Parsing stays on the host;
what an importer returns lands on ``device``, the CUDA device unless
named.

Gaussian-splat properties (INRIA 3DGS): x/y/z, opacity (logit),
scale_0..2 (log), rot_0..3 (wxyz quaternion), f_dc_0..2 and f_rest_* (SH).
"""

import os

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _host
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["import_mesh", "import_pointcloud", "import_gaussians",
           "export_pointcloud", "export_gaussians", "read_ply", "write_ply",
           "import_gaussiancloud", "export_gaussiancloud"]

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _le(ply_type):
    return np.dtype("<" + _PLY_TYPES[ply_type])


def _read_element_loop(body, pos, count, props):
    """One element's properties, item by item → (columns, end)."""
    cols = {p[0]: [] for p in props}
    for _ in range(count):
        for pname, ptype, ltype in props:
            vt = _le(ptype)
            if ltype is not None:
                lt = _le(ltype)
                n = int(np.frombuffer(body, lt, 1, pos)[0])
                pos += lt.itemsize
                cols[pname].append(np.frombuffer(body, vt, n, pos).tolist())
                pos += vt.itemsize * n
            else:
                cols[pname].append(np.frombuffer(body, vt, 1, pos)[0])
                pos += vt.itemsize
    return {k: _column(v) for k, v in cols.items()}, pos


def _column(values):
    """A column of scalars or of lists; lists of varying lengths → an
    object array, as the ASCII reader makes them."""
    if values and isinstance(values[0], list) \
            and any(len(x) != len(values[0]) for x in values):
        return np.asarray(values, dtype=object)
    return np.asarray(values)


def _read_element_fixed(body, pos, count, props):
    """One element whose every list has the length of the first item's: a
    structured read → (columns as the loop gives them, end), or None when
    some item's list lengths differ. List values come back as int64 or
    float64, as the loop's ``tolist`` makes them."""
    fields, probe = [], pos
    for pname, ptype, ltype in props:
        if ltype is not None:
            n = int(np.frombuffer(body, _le(ltype), 1, probe)[0])
            fields += [(f"{pname}__n", _le(ltype)), (pname, _le(ptype), (n,))]
            probe += _le(ltype).itemsize + _le(ptype).itemsize * n
        else:
            fields.append((pname, _le(ptype)))
            probe += _le(ptype).itemsize
    dt = np.dtype(fields)
    if pos + dt.itemsize * count > len(body):
        return None
    arr = np.frombuffer(body, dt, count, pos)
    cols = {}
    for pname, ptype, ltype in props:
        if ltype is None:
            cols[pname] = np.ascontiguousarray(arr[pname])
            continue
        if (arr[f"{pname}__n"] != dt[pname].shape[0]).any():
            return None
        kind = np.int64 if dt[pname].base.kind in "iu" else np.float64
        cols[pname] = arr[pname].astype(kind)
    return cols, pos + dt.itemsize * count


def read_ply(path):
    """Parse a PLY file → dict element_name → dict of property arrays
    (ragged list properties → object arrays)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="ignore").splitlines()
    body = data[end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    out = {}
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="ignore").split()
        pos = 0
        for name, count, props in elements:
            cols = {p[0]: [] for p in props}
            for _ in range(count):
                for pname, ptype, ltype in props:
                    if ltype is not None:
                        n = int(tokens[pos])
                        pos += 1
                        cols[pname].append(
                            [float(tokens[pos + i]) for i in range(n)])
                        pos += n
                    else:
                        cols[pname].append(float(tokens[pos]))
                        pos += 1
            out[name] = {k: (np.asarray(v) if not isinstance(v[0], list)
                             else np.asarray(v, dtype=object)
                             if any(len(x) != len(v[0]) for x in v)
                             else np.asarray(v))
                         for k, v in cols.items()} if count else {}
    elif fmt == "binary_little_endian":
        pos = 0
        for name, count, props in elements:
            got = None
            if count:
                got = _read_element_fixed(body, pos, count, props)
            if got is None:
                got = _read_element_loop(body, pos, count, props)
            out[name], pos = got
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return out


def _fan(rows):
    """Face rows (an (F, n) array or a ragged object array) → triangles
    (v0, v_i, v_i+1) of each face in turn."""
    if rows.dtype != object and rows.ndim == 2:
        n = rows.shape[1]
        if n < 3:
            return np.zeros((0, 3), np.int64)
        tris = np.stack([np.repeat(rows[:, :1], n - 2, axis=1),
                         rows[:, 1:-1], rows[:, 2:]], axis=-1)
        return tris.reshape(-1, 3).astype(np.int64)
    faces = []
    for r in rows:
        r = list(r)
        for i in range(1, len(r) - 1):
            faces.append([r[0], r[i], r[i + 1]])
    return np.asarray(faces, dtype=np.int64)


def _colors(v):
    if not all(c in v for c in ("red", "green", "blue")):
        return None
    col = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32)
    return col / 255.0 if col.max() > 1 else col


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def import_mesh(path, device=None):
    """PLY mesh → SurfaceMesh on ``device`` (the CUDA device unless named):
    vertices, faces fanned into triangles, vertex colours (divided by 255
    where their max exceeds 1)."""
    device = resolve_device(device, "ply.import_mesh")
    data = read_ply(path)
    v = data["vertex"]
    vertices = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    kwargs = dict(vertices=_t(vertices, device))
    if "face" in data and data["face"]:
        key = "vertex_indices" if "vertex_indices" in data["face"] \
            else "vertex_index"
        kwargs["faces"] = _t(_fan(data["face"][key]), device)
    col = _colors(v)
    if col is not None:
        kwargs["vertex_colors"] = _t(col, device)
    return SurfaceMesh(**kwargs)


def import_pointcloud(path, device=None):
    """PLY → (points (N, 3), colors or None, normals or None) on
    ``device``."""
    device = resolve_device(device, "ply.import_pointcloud")
    v = read_ply(path)["vertex"]
    pts = _t(np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32),
             device)
    col = _colors(v)
    normals = None
    if all(c in v for c in ("nx", "ny", "nz")):
        normals = _t(np.stack([v["nx"], v["ny"], v["nz"]], -1)
                     .astype(np.float32), device)
    return pts, None if col is None else _t(col, device), normals


def import_gaussians(path, device=None):
    """INRIA-format 3DGS ply → dict of tensors on ``device``: positions,
    opacities (logit), scales (log), rotations (wxyz) and sh_coeffs
    (N, 1 + rest, 3)."""
    device = resolve_device(device, "ply.import_gaussians")
    v = read_ply(path)["vertex"]
    out = {
        "positions": np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32),
        "opacities": np.asarray(v["opacity"], dtype=np.float32),
        "scales": np.stack([v[f"scale_{i}"] for i in range(3)], -1)
        .astype(np.float32),
        "rotations": np.stack([v[f"rot_{i}"] for i in range(4)], -1)
        .astype(np.float32),
    }
    dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)
    rest_keys = sorted([k for k in v if k.startswith("f_rest_")],
                       key=lambda s: int(s.split("_")[-1]))
    if rest_keys:
        rest = np.stack([v[k] for k in rest_keys], -1).astype(np.float32)
        nb = len(rest_keys) // 3
        rest = rest.reshape(-1, 3, nb).transpose(0, 2, 1)
        sh = np.concatenate([dc[:, None, :], rest], axis=1)
    else:
        sh = dc[:, None, :]
    out["sh_coeffs"] = sh
    return {k: _t(val, device) for k, val in out.items()}


def write_ply(path, vertex_props, faces=None, binary=True):
    """Write a PLY file from a dict of per-vertex property arrays (each
    written as float32) and optional faces."""
    names = list(vertex_props.keys())
    arrays = [_host(vertex_props[n]).astype(np.float32) for n in names]
    n = arrays[0].shape[0]
    faces = None if faces is None else _host(faces)
    with open(path, "wb") as f:
        hdr = ["ply",
               "format binary_little_endian 1.0" if binary
               else "format ascii 1.0",
               f"element vertex {n}"]
        hdr += [f"property float {name}" for name in names]
        if faces is not None:
            hdr += [f"element face {len(faces)}",
                    "property list uchar int vertex_indices"]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        table = np.stack(arrays, axis=-1)
        if binary:
            f.write(table.astype("<f4").tobytes())
            if faces is not None:
                # each face: its vertex count (uchar), then its indices
                rows = np.zeros(len(faces), np.dtype(
                    [("n", "u1"), ("idx", "<i4", (faces.shape[1],))]))
                rows["n"] = faces.shape[1]
                rows["idx"] = faces
                f.write(rows.tobytes())
        else:
            for row in table:
                f.write((" ".join(f"{x:g}" for x in row) + "\n").encode())
            if faces is not None:
                for face in faces:
                    f.write((f"{len(face)} "
                             + " ".join(str(i) for i in face) + "\n").encode())


def export_pointcloud(path, points, colors=None, normals=None):
    """Write a binary PLY of points, with optional normals and colours."""
    points = _host(points)
    props = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    if normals is not None:
        normals = _host(normals)
        props.update(nx=normals[:, 0], ny=normals[:, 1], nz=normals[:, 2])
    if colors is not None:
        c = _host(colors)
        props.update(red=c[:, 0], green=c[:, 1], blue=c[:, 2])
    write_ply(path, props)


def export_gaussians(path, positions, opacities, scales, rotations,
                     sh_coeffs):
    """Write an INRIA-format 3DGS ply of raw (pre-activation) values."""
    positions, sh = _host(positions), _host(sh_coeffs)
    scales, rotations = _host(scales), _host(rotations)
    n = positions.shape[0]
    props = {"x": positions[:, 0], "y": positions[:, 1],
             "z": positions[:, 2], "nx": np.zeros(n), "ny": np.zeros(n),
             "nz": np.zeros(n)}
    for i in range(3):
        props[f"f_dc_{i}"] = sh[:, 0, i]
    rest = sh[:, 1:].transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    props["opacity"] = _host(opacities).reshape(-1)
    for i in range(3):
        props[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        props[f"rot_{i}"] = rotations[:, i]
    write_ply(path, props)


def import_gaussiancloud(filename, apply_activations=True, device=None):
    """INRIA 3DGS ply → GaussianSplatModel on ``device`` (the CUDA device
    unless named), with the sigmoid of the opacities, the exp of the scales
    and the quaternions normalized unless ``apply_activations`` is False."""
    from kaolin_tpu_torch.rep.gaussians import GaussianSplatModel
    d = import_gaussians(filename, device)
    return GaussianSplatModel.from_gaussian_dict(d,
                                                 activated=apply_activations)


def export_gaussiancloud(file_path, positions, orientations, scales,
                         opacities, sh_coeff, overwrite=False):
    """Write a 3DGS ply in raw (pre-activation) space: the log of the
    scales and the logit of the opacities, in float64, and the (w, x, y,
    z) quaternions as given."""
    if not overwrite and os.path.exists(file_path):
        raise RuntimeError(f"Cannot overwrite: {file_path}")
    eps = 1e-7
    op = np.clip(_host(opacities).astype(np.float64).reshape(-1),
                 eps, 1 - eps)
    raw_op = np.log(op / (1.0 - op))
    raw_scales = np.log(np.clip(_host(scales).astype(np.float64), eps, None))
    export_gaussians(file_path, positions, raw_op, raw_scales, orientations,
                     sh_coeff)


def __getattr__(name):
    if name == "GaussianSplatModel":
        from kaolin_tpu_torch.rep.gaussians import GaussianSplatModel
        return GaussianSplatModel
    raise AttributeError(name)
