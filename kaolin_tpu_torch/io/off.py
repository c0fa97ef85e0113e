"""OFF mesh import/export. Counterpart of ``kaolin_tpu/io/off.py``."""

from collections import namedtuple

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _host
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["import_mesh", "export_mesh"]

# named return container of the reference's API
return_type = namedtuple("return_type", ["vertices", "faces", "face_colors"])


def import_mesh(path, with_face_colors=False, device=None):
    """Import an OFF file → unbatched SurfaceMesh on ``device`` (the CUDA
    device unless named). Face colours above 1 are taken as 0-255."""
    device = resolve_device(device, "off.import_mesh")
    with open(path, "r", errors="ignore") as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.append(line)
    header = tokens[0]
    idx = 1
    if header.startswith("OFF") and len(header) > 3:
        counts = header[3:].split()
    elif header == "OFF":
        counts = tokens[idx].split()
        idx += 1
    else:
        counts = header.split()
    nv, nf = int(counts[0]), int(counts[1])
    verts = np.asarray([[float(x) for x in tokens[idx + i].split()[:3]]
                        for i in range(nv)], dtype=np.float32)
    idx += nv
    faces, colors = [], []
    for i in range(nf):
        parts = tokens[idx + i].split()
        c = int(parts[0])
        faces.append([int(x) for x in parts[1:1 + c]])
        if with_face_colors and len(parts) > 1 + c:
            colors.append([float(x) for x in parts[1 + c:1 + c + 3]])
    fsz = len(faces[0]) if faces else 3
    if any(len(f) != fsz for f in faces):
        raise ValueError(f"{path}: faces of varying sizes are not supported")

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    kwargs = dict(vertices=t(verts), faces=t(np.asarray(faces,
                                                        dtype=np.int64)))
    if with_face_colors and colors:
        col = np.asarray(colors, dtype=np.float32)
        if col.max() > 1:
            col = col / 255.0
        kwargs["face_colors"] = t(np.repeat(col[:, None, :], fsz, axis=1))
    return SurfaceMesh(**kwargs)


def export_mesh(path, vertices, faces):
    """Write an OFF file."""
    v, f_np = _host(vertices), _host(faces)
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{v.shape[0]} {f_np.shape[0]} 0\n")
        for x in v:
            f.write(f"{x[0]} {x[1]} {x[2]}\n")
        for face in f_np:
            f.write(f"{len(face)} " + " ".join(str(i) for i in face) + "\n")
