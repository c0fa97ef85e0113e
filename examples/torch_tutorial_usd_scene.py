"""Tutorial: authoring and reading multi-object USD scenes with
kaolin_tpu_torch.

The port of ``examples/tutorial_usd_scene.py`` at its size: a USD stage
holding several meshes, a point cloud and a voxelgrid under distinct scene
paths, enumerated with ``get_scene_paths``, every mesh imported again, and
the same scene through the binary ``.usdc`` Crate writer — with the
dependency-free USD backend (``kaolin_tpu_torch/io/usd``; no ``pxr``).
Imports land on the CUDA device unless ``cpu`` is named.

    PYTHONPATH=. python examples/torch_tutorial_usd_scene.py [cuda|cpu] [smoke]
"""

import functools
import importlib.util
import os
import sys
import tempfile

import numpy as np
import torch

from kaolin_tpu_torch.io import usd
from kaolin_tpu_torch.ops.mesh import sample_points
from kaolin_tpu_torch.utils.backend import resolve_device


@functools.cache
def _sibling(name):
    """``examples/<name>.py`` as a module, loaded once a process."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _box(center, half):
    c = np.asarray(center, np.float32)
    v = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                    for z in (-1, 1)], np.float32) * half + c
    f = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def main(device=None, smoke=False):
    """Author, enumerate and import the scene as ``.usda`` (and ``.usdc``
    unless ``smoke``) on ``device`` → dict of the counts."""
    device = resolve_device(device, "main")
    make_icosphere = _sibling("torch_tutorial_camera_rasterization") \
        .make_icosphere
    sphere_v, sphere_f = make_icosphere(1 if smoke else 2)
    sphere_v, sphere_f = np.asarray(sphere_v), np.asarray(sphere_f)
    table_v, table_f = _box([0.0, -0.6, 0.0], 0.5)
    cup_v, cup_f = _box([0.3, -0.05, 0.1], 0.08)
    meshes = {
        "/World/Sphere": (sphere_v, sphere_f),
        "/World/Table": (table_v, table_f),
        "/World/Cup": (cup_v, cup_f),
    }
    pts, _ = sample_points(torch.as_tensor(sphere_v, device=device)[None],
                           torch.as_tensor(sphere_f, device=device),
                           128 if smoke else 1024,
                           generator=torch.Generator(device).manual_seed(0))
    vox = np.zeros((8, 8, 8), bool)
    vox[2:6, 2:6, 2:6] = True

    with tempfile.TemporaryDirectory() as d:
        for ext in (("usda",) if smoke else ("usda", "usdc")):
            path = os.path.join(d, f"kitchen.{ext}")
            # one stage, many prims
            stage = usd.create_stage(path)
            for scene_path, (v, f) in meshes.items():
                usd.add_mesh(stage, scene_path, vertices=v, faces=f)
            usd.add_pointcloud(stage, "/World/Crumbs", pts[0])
            usd.add_voxelgrid(stage, "/World/IceBlock", vox)
            stage.save()

            # enumerate prims by type
            mesh_paths = usd.get_scene_paths(path, prim_types=["Mesh"])
            assert set(mesh_paths) >= set(meshes), mesh_paths

            # bulk re-import and per-path spot checks
            back = usd.import_meshes(path, device=device)
            assert len(back) >= len(meshes)
            assert all(m.vertices.device.type == device.type for m in back)
            one = usd.import_mesh(path, scene_path="/World/Cup",
                                  device=device)
            np.testing.assert_allclose(one.vertices.cpu().numpy(), cup_v,
                                       atol=1e-5)
            sph = usd.import_mesh(path, scene_path="/World/Sphere",
                                  device=device)
            assert sph.faces.shape[0] == sphere_f.shape[0]
            grid = usd.import_voxelgrid(path, device=device)
            assert torch.equal(grid.cpu(), torch.from_numpy(vox))
    out = {"prims": len(mesh_paths) + 2,
           "formats": "usda" if smoke else "usda+usdc"}
    print("usd_scene:", out)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    main(next((x for x in args if x != "smoke"), None),
         smoke="smoke" in args)
