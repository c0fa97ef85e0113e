"""Tutorial: working with meshes (``SurfaceMesh``), with kaolin_tpu_torch.
The counterpart of ``examples/tutorial_working_with_meshes.py``: build a
mesh, tour the ``SurfaceMesh`` attribute system (lazy auto-compute,
batching, ``cat``), run common ops (surface sampling, subdivision,
normals), and round-trip it through an OBJ file.

It runs on the CUDA device unless ``cpu`` is named; ``smoke`` runs it at a
small size:

    PYTHONPATH=. python examples/torch_tutorial_working_with_meshes.py \
        [cuda|cpu] [smoke]
"""

import importlib.util
import os
import sys
import tempfile

import torch

from kaolin_tpu_torch.io import obj
from kaolin_tpu_torch.ops.mesh import sample_points, subdivide_trianglemesh
from kaolin_tpu_torch.rep import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(device=None, smoke=False):
    """The tutorial on ``device`` (the CUDA device unless named), with its
    checks → the mesh."""
    device = resolve_device(device, "main")
    vertices, faces = _sibling("torch_tutorial_camera_rasterization") \
        .make_icosphere(1 if smoke else 2)

    # 1. construct a SurfaceMesh and let the lazy attribute graph work:
    # face_vertices, face_normals and vertex_normals are computed (and
    # cached) on first access
    mesh = SurfaceMesh(vertices=torch.as_tensor(vertices, device=device),
                       faces=torch.as_tensor(faces, device=device))
    assert mesh.batching == SurfaceMesh.Batching.NONE
    assert not mesh.has_attribute("face_normals")
    fn = mesh.face_normals
    assert fn.shape in ((faces.shape[0], 3, 3), (faces.shape[0], 3)), \
        fn.shape
    vn = mesh.vertex_normals
    assert vn.shape == (vertices.shape[0], 3)
    # unit sphere: vertex normals point along the vertices
    cos = (vn * mesh.vertices).sum(-1) \
        / torch.linalg.vector_norm(mesh.vertices, dim=-1) \
        / torch.linalg.vector_norm(vn, dim=-1).clamp(min=1e-6)
    assert bool((cos > 0.9).all()), "sphere vertex normals must be radial"

    # 2. batching: FIXED stacks same-topology meshes; cat() builds it
    batched = SurfaceMesh.cat([mesh, mesh], fixed_topology=True)
    assert batched.batching == SurfaceMesh.Batching.FIXED
    assert batched.vertices.shape == (2,) + tuple(mesh.vertices.shape)

    # 3. ops: area-weighted surface sampling and loop subdivision
    pts, _ = sample_points(mesh.vertices[None], mesh.faces,
                           256 if smoke else 4096,
                           generator=torch.Generator(device).manual_seed(0))
    r = torch.linalg.vector_norm(pts[0], dim=-1)
    assert abs(float(r.mean()) - 1.0) < 0.1, "samples lie on the unit sphere"

    sub_v, sub_f = subdivide_trianglemesh(mesh.vertices[None], mesh.faces,
                                          iterations=1)
    assert sub_f.shape[0] == 4 * mesh.faces.shape[0]

    # 4. round-trip through OBJ
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sphere.obj")
        obj.export_mesh(path, vertices=mesh.vertices, faces=mesh.faces)
        back = obj.import_mesh(path, device=device)
        assert torch.allclose(back.vertices, mesh.vertices, atol=1e-5)
        assert torch.equal(back.faces.to(mesh.faces.dtype), mesh.faces)
    print("working_with_meshes:",
          {"V": int(mesh.vertices.shape[0]), "F": int(mesh.faces.shape[0]),
           "subdivided_F": int(sub_f.shape[0])})
    return mesh


if __name__ == "__main__":
    args = sys.argv[1:]
    main(next((a for a in args if a != "smoke"), None), "smoke" in args)
