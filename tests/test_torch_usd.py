"""kaolin_tpu_torch.io.usd against kaolin_tpu.io.usd, on the CPU.

Every exporter writes the JAX package's files byte for byte, ``.usda`` and
``.usdc``, from torch tensors where JAX is given numpy arrays: meshes with
UVs, subsets and a transform, time-sampled meshes and point clouds with
colours, voxelgrids, gaussians, physics materials, skinned physics,
UsdPreviewSurface materials with their textures (PNG bytes too) and the
``UsdMaterialIoManager``. Each package reads the other's files (and
``.usdz`` packages of them), and every reader's result equals JAX's on the
same file: meshes (with ``time``), point clouds and their bracketing time
samples, voxelgrids, gaussians, physics, materials, subsets, raw geometry,
scene paths, transforms. The prim scan gives the JAX package's prim lists.

The JAX faults the port does not copy (ROADMAP Queue C), each shown beside
the port's result: F33 (every ``materialBind`` subset gets the file's first
shader), F34 (braces inside strings and asset paths end a prim), F35 (a
point cloud with normals raises), F36 (a ``.usdc`` transform reads as
identity), F37 (a ``.usdc`` material loses its colours and maps).
"""

import os
import re
import zipfile
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.io.usd as jusd
import kaolin_tpu.io.usd.core as jcore
import kaolin_tpu_torch.io.usd as tusd
import kaolin_tpu_torch.io.usd.core as tcore
from kaolin_tpu.io.utils import TextureExporter as JTextureExporter
from kaolin_tpu.physics.simplicits import training as jtrain
from kaolin_tpu.render.materials import PBRMaterial as JPBRMaterial
from kaolin_tpu_torch.io.utils import TextureExporter as TTextureExporter
from kaolin_tpu_torch.physics.simplicits import training as ttrain
from kaolin_tpu_torch.render.materials import PBRMaterial as TPBRMaterial
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

RNG = np.random.RandomState(0)
F32 = np.float32
V = RNG.randn(30, 3).astype(F32)
F = RNG.randint(0, 30, (40, 3)).astype(np.int64)
UV = RNG.rand(35, 2).astype(F32)
FUV = RNG.randint(0, 35, (40, 3)).astype(np.int64)
PTS = [RNG.randn(25, 3).astype(F32) for _ in range(3)]
COLORS = [RNG.rand(25, 3).astype(F32) for _ in range(3)]
VOX = RNG.rand(6, 6, 6) > 0.6
XFORM = np.array([[1.5, 0.0, 0.0, 0.0], [0.0, 0.5, 0.25, 0.0],
                  [0.0, -0.25, 0.5, 0.0], [0.125, -0.5, 2.0, 1.0]])
GAUSS = {"positions": RNG.randn(12, 3).astype(F32),
         "orientations": RNG.randn(12, 4).astype(F32),
         "scales": RNG.rand(12, 3).astype(F32),
         "opacities": RNG.rand(12).astype(F32),
         "sh_coeff": RNG.randn(12, 9, 3).astype(F32)}
PHYS = {"pts": RNG.randn(20, 3).astype(F32), "yms": RNG.rand(20).astype(F32),
        "prs": np.full(20, 0.35, F32), "rhos": RNG.rand(20).astype(F32),
        "appx_vol": 0.75, "sw": RNG.rand(20, 4).astype(F32),
        "dwdx": RNG.randn(20, 4, 3).astype(F32),
        "rpts": RNG.randn(9, 3).astype(F32),
        "rsw": RNG.rand(9, 4).astype(F32)}
TEX = {"diffuse": RNG.rand(8, 8, 3).astype(F32),
       "roughness": RNG.rand(8, 8, 1).astype(F32),
       "metallic": RNG.rand(8, 8, 1).astype(F32),
       "normals": RNG.rand(8, 8, 3).astype(F32)}
MAT_VALUES = {"diffuse_color": (0.5, 0.25, 1.0), "roughness_value": 0.3,
              "metallic_value": 0.125, "specular_color": (0.2, 0.4, 0.6),
              "opacity_value": 0.9, "ior_value": 1.45}


class Pkg(namedtuple("Pkg", "usd core arr TextureExporter PBRMaterial "
                             "train")):
    """One package's USD module and how it takes inputs."""


JAX = Pkg(jusd, jcore, lambda x: x, JTextureExporter, JPBRMaterial, jtrain)
PORT = Pkg(tusd, tcore, lambda x: torch.as_tensor(np.asarray(x)),
           TTextureExporter, TPBRMaterial, ttrain)


def _material(p, name="m", textures=True):
    kw = dict(MAT_VALUES)
    if textures:
        kw.update({f"{k}_texture": p.arr(v) for k, v in TEX.items()})
    return p.PBRMaterial(material_name=name, **kw)


def _skinned(p):
    t = p.train
    return t.SkinnedPhysicsPoints(
        p.arr(PHYS["pts"]), p.arr(PHYS["yms"]), p.arr(PHYS["prs"]),
        p.arr(PHYS["rhos"]), PHYS["appx_vol"], p.arr(PHYS["sw"]),
        p.arr(PHYS["dwdx"]),
        renderable=t.SkinnedPoints(p.arr(PHYS["rpts"]), p.arr(PHYS["rsw"])))


# -- the exporters -------------------------------------------------------------
def _mesh(p, path):
    stage = p.usd.create_stage(path)
    p.usd.add_mesh(stage, "/World/mesh", p.arr(V), p.arr(F), uvs=p.arr(UV),
                   face_uvs_idx=p.arr(FUV))
    p.usd.add_subset(stage, "/World/mesh", "front", p.arr(np.arange(25)),
                     family_name="materialBind")
    p.usd.add_subset(stage, "/World/mesh", "back", p.arr(np.arange(25, 40)),
                     family_name="materialBind")
    p.usd.add_subset(stage, "/World/mesh", "part", p.arr(np.arange(3)))
    p.usd.set_local_to_world_transform(stage, "/World/mesh", p.arr(XFORM))
    p.usd.add_mesh(stage, "/World/quads", p.arr(V[:8]),
                   p.arr(np.array([[0, 1, 2, 3], [4, 5, 6, 7]])))
    stage.save()


def _mesh_time(p, path):
    stage = p.usd.create_stage(path, up_axis="Z")
    for t in range(3):
        p.usd.add_mesh(stage, "/World/mesh", p.arr(V * (1 + t)),
                       p.arr(F) if t == 0 else None, time=t)
    stage.save()


def _export_meshes(p, path):
    p.usd.export_meshes(path, ["/World/a", "/World/b/c"],
                        [p.arr(V), p.arr(V[::-1].copy())],
                        [p.arr(F), p.arr(F[:5])])


def _export_mesh(p, path):
    p.usd.export_mesh(path, "/World/m", p.arr(V), p.arr(F), uvs=p.arr(UV),
                      face_uvs_idx=p.arr(FUV))


def _points_time(p, path):
    stage = p.usd.create_stage(path)
    for t, (pts, c) in enumerate(zip(PTS, COLORS)):
        p.usd.add_pointcloud(stage, "/World/cloud", p.arr(pts), time=5 * t,
                             colors=p.arr(c))
    stage.save()


def _pointclouds(p, path):
    p.usd.export_pointclouds(path, [p.arr(x) for x in PTS],
                             colors=[p.arr(x) for x in COLORS])
    p.usd.export_pointcloud(path.replace(".usd", "_one.usd"),
                            p.arr(PTS[0]))


def _voxelgrids(p, path):
    p.usd.export_voxelgrids(path, [p.arr(VOX), p.arr(VOX[::-1].copy())])
    p.usd.export_voxelgrid(path.replace(".usd", "_one.usd"), p.arr(VOX))


def _gaussians(p, path):
    stage = p.usd.create_stage(path)
    g = {k: p.arr(v) for k, v in GAUSS.items()}
    p.usd.add_gaussiancloud(stage, "/World/Gaussians/a", **g,
                            local_to_world=p.arr(XFORM))
    p.usd.add_gaussiancloud(stage, "/World/Gaussians/b",
                            g["positions"] * 2, g["orientations"],
                            g["scales"], g["opacities"], g["sh_coeff"])
    stage.save()
    p.usd.export_gaussiancloud(path.replace(".usd", "_one.usd"),
                               g["positions"], g["orientations"],
                               g["scales"], g["opacities"])   # SH DC only


def _physics(p, path):
    stage = p.usd.create_stage(path)
    t = p.train
    for name, scale in (("rubber", 1.0), ("wood", 2.0)):
        p.usd.add_physics_material(
            stage, "/World/obj", t.PhysicsPoints(
                p.arr(PHYS["pts"] * scale), p.arr(PHYS["yms"]),
                p.arr(PHYS["prs"]), p.arr(PHYS["rhos"]), PHYS["appx_vol"]),
            material_name=name)
    p.usd.add_skinned_physics(stage, "/World/skinned", _skinned(p),
                              instance_name="body")
    stage.save()


def _material_file(p, path):
    p.usd.export_material(_material(p), path, "/World/Looks/m")


def _manager(p, path):
    stage = p.usd.create_stage(path)
    exporter = p.TextureExporter(os.path.dirname(path))
    p.usd.UsdMaterialIoManager.write_material(
        _material(p, "a"), stage, "/World/Looks/a",
        write_texture_by_basename_fn=exporter)
    p.usd.UsdMaterialIoManager.write_material(
        _material(p, "b", textures=False), stage, "/World/Looks/b")
    stage.save()


EXPORTERS = {"mesh": _mesh, "mesh_time": _mesh_time,
             "export_meshes": _export_meshes, "export_mesh": _export_mesh,
             "points_time": _points_time, "pointclouds": _pointclouds,
             "voxelgrids": _voxelgrids, "gaussians": _gaussians,
             "physics": _physics, "material": _material_file,
             "manager": _manager}


def _written(tmp_path, case, ext):
    """The case written by both packages → {"jax": dir, "port": dir}, each
    holding ``a.<ext>`` and whatever the case writes beside it."""
    out = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        EXPORTERS[case](p, str(d / f"a.{ext}"))
        out[name] = d
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("ext", ["usda", "usdc"])
@pytest.mark.parametrize("case", sorted(EXPORTERS))
def test_exporters_write_jax_bytes(case, ext, tmp_path):
    dirs = _written(tmp_path, case, ext)
    names = _files(dirs["jax"])
    assert names == _files(dirs["port"]) and f"a.{ext}" in names
    for name in names:
        assert (dirs["port"] / name).read_bytes() == \
            (dirs["jax"] / name).read_bytes(), name


def test_stage_keeps_what_it_was_given(tmp_path):
    """The text is formatted at save; a tensor changed after ``add_mesh``
    does not change the file."""
    v = torch.from_numpy(V.copy())
    stage = tusd.create_stage(str(tmp_path / "t.usda"))
    tusd.add_mesh(stage, "/World/mesh", v, torch.from_numpy(F))
    v.mul_(2.0)
    stage.save()
    jusd.export_meshes(str(tmp_path / "j.usda"), ["/World/mesh"], [V], [F])
    assert (tmp_path / "t.usda").read_bytes() == \
        (tmp_path / "j.usda").read_bytes()


# -- the readers -----------------------------------------------------------------
def _plain(x):
    """A result of either package as plain Python and numpy."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (np.ndarray, np.generic, jnp.ndarray)):
        return np.asarray(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _plain(getattr(x, k)) for k in x._fields}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "sh_coeff"):
        return {k: _plain(getattr(x, k)) for k in (
            "positions", "orientations", "scales", "opacities", "sh_coeff")}
    if hasattr(x, "get_attributes") and hasattr(x, "vertices"):
        return {k: _plain(x.get_attribute(k))
                for k in x.get_attributes(only_tensors=True)}
    if hasattr(x, "is_specular_workflow"):   # a material
        return {k: _plain(getattr(x, k)) for k in x.get_attributes(
            only_tensors=True)} | {"is_specular_workflow":
                                   x.is_specular_workflow}
    if hasattr(x, "appx_vol"):
        keys = ("pts", "yms", "prs", "rhos", "appx_vol", "skinning_weights",
                "dwdx")
        out = {k: _plain(getattr(x, k)) for k in keys if hasattr(x, k)}
        if getattr(x, "renderable", None) is not None:
            out["renderable"] = {k: _plain(getattr(x.renderable, k))
                                 for k in ("pts", "skinning_weights")}
        return out
    raise TypeError(type(x))


def assert_same(got, want, path="result"):
    got, want = _plain(got), _plain(want)
    _same(got, want, path)


def _same(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _port(fn):
    """A reader of the port, on the CPU."""
    return lambda *a, **k: fn(*a, device="cpu", **k)


READERS = {
    "mesh": [
        lambda u, f: (_port(u.import_meshes) if u is tusd
                      else u.import_meshes)(f),
        lambda u, f: (_port(u.import_mesh) if u is tusd
                      else u.import_mesh)(f, scene_path="/World/quads"),
        lambda u, f: (_port(u.import_subsets) if u is tusd
                      else u.import_subsets)(f, "/World/mesh"),
        lambda u, f: (_port(u.import_subsets) if u is tusd
                      else u.import_subsets)(f, None, "materialBind"),
        lambda u, f: (_port(u.get_raw_mesh_prim_geometry) if u is tusd
                      else u.get_raw_mesh_prim_geometry)(
            f, "/World/quads", with_normals=True, with_uvs=True),
        lambda u, f: u.get_scene_paths(f),
        lambda u, f: u.get_scene_paths(f, r"/World/m", ["Mesh",
                                                         "GeomSubset"]),
        lambda u, f: u.get_mesh_scene_paths(f),
    ],
    "mesh_time": [
        lambda u, f: [(_port(u.import_mesh) if u is tusd else u.import_mesh)(
            f, time=t) for t in (None, 0, 1, 1.4, 2, 7)],
        lambda u, f: u.get_authored_time_samples(f),
    ],
    "export_meshes": [
        lambda u, f: (_port(u.import_meshes) if u is tusd
                      else u.import_meshes)(f, scene_paths=["/World/b/c",
                                                            "/World/a"]),
    ],
    "export_mesh": [
        lambda u, f: (_port(u.import_mesh) if u is tusd
                      else u.import_mesh)(f),
    ],
    "points_time": [
        lambda u, f: [(_port(u.import_pointcloud) if u is tusd
                       else u.import_pointcloud)(f, time=t)
                      for t in (None, 0, 4, 10)],
        lambda u, f: [u.get_pointcloud_bracketing_time_samples(
            f, "/World/cloud", t) for t in (-1, 0, 3, 5, 7.5, 12)],
        lambda u, f: u.get_authored_time_samples(f),
        lambda u, f: u.get_pointcloud_scene_paths(f),
    ],
    "pointclouds": [
        lambda u, f: (_port(u.import_pointclouds) if u is tusd
                      else u.import_pointclouds)(f),
        lambda u, f: (_port(u.import_pointclouds) if u is tusd
                      else u.import_pointclouds)(
            f, scene_paths=["/World/pointcloud_1"]),
        lambda u, f: (_port(u.import_pointcloud) if u is tusd
                      else u.import_pointcloud)(
            f, scene_path="/World/pointcloud_2"),
    ],
    "voxelgrids": [
        lambda u, f: (_port(u.import_voxelgrids) if u is tusd
                      else u.import_voxelgrids)(f),
        lambda u, f: (_port(u.import_voxelgrid) if u is tusd
                      else u.import_voxelgrid)(f),
    ],
    "gaussians": [
        lambda u, f: (_port(u.import_gaussianclouds) if u is tusd
                      else u.import_gaussianclouds)(f),
        lambda u, f: (_port(u.import_gaussiancloud) if u is tusd
                      else u.import_gaussiancloud)(f),
        lambda u, f: (_port(u.import_gaussiancloud) if u is tusd
                      else u.import_gaussiancloud)(f, "/World/Gaussians/b"),
        lambda u, f: u.get_gaussiancloud_scene_paths(f, "/World/Gaussians"),
    ],
    "physics": [
        lambda u, f: (_port(u.get_physics_material) if u is tusd
                      else u.get_physics_material)(
            f, material_name="wood"),
        lambda u, f: (_port(u.get_skinned_physics) if u is tusd
                      else u.get_skinned_physics)(f, instance_name="body"),
        lambda u, f: (_port(u.get_all_physics_materials) if u is tusd
                      else u.get_all_physics_materials)(f),
        lambda u, f: (_port(u.get_all_skinned_physics) if u is tusd
                      else u.get_all_skinned_physics)(f),
        lambda u, f: u.get_physics_materials_instance_names(f),
        lambda u, f: u.get_skinned_physics_instance_names(f),
    ],
    "material": [
        lambda u, f: (_port(u.import_material) if u is tusd
                      else u.import_material)(f),
        lambda u, f: (_port(u.read_usd_preview_surface) if u is tusd
                      else u.read_usd_preview_surface)(f, "/World/Looks/m"),
    ],
    "manager": [
        lambda u, f: (_port(u.read_usd_preview_surface) if u is tusd
                      else u.read_usd_preview_surface)(f, "/World/Looks/b"),
        lambda u, f: (_port(u.UsdMaterialIoManager.read_material)
                      if u is tusd else u.UsdMaterialIoManager.read_material)(
            f, "/World/Looks/a"),
        lambda u, f: u.UsdMaterialIoManager._raw_shader_params(
            f, "/World/Looks/a"),
    ],
}


def _usdz(path):
    """``path`` packed alone into a ``.usdz`` beside it (stored, as USDZ
    packages are) → the package's path."""
    out = os.path.splitext(path)[0] + "_pkg.usdz"
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.write(path, os.path.basename(path))
    return out


# the materials of a binary layer, which JAX reads wrong (F37): the port's
# results there are held by test_usdc_material_keeps_colours_and_maps_f37
READ_CASES = [(case, ext) for case in sorted(READERS)
              for ext in ("usda", "usdc", "usdz")
              if case not in ("material", "manager") or ext == "usda"]


@pytest.mark.parametrize("case,ext", READ_CASES)
def test_readers_match_jax_on_each_others_files(case, ext, tmp_path):
    """The port reads JAX's file and JAX reads the port's: both give what
    JAX gives on its own file."""
    dirs = _written(tmp_path, case, "usdc" if ext == "usdz" else ext)
    files = {k: str(d / f"a.{'usdc' if ext == 'usdz' else ext}")
             for k, d in dirs.items()}
    if ext == "usdz":
        files = {k: _usdz(f) for k, f in files.items()}
    for read in READERS[case]:
        want = read(jusd, files["jax"])
        assert_same(read(tusd, files["jax"]), want)
        assert_same(read(jusd, files["port"]), want)


@pytest.mark.parametrize("case", sorted(EXPORTERS))
def test_prim_scan_gives_jax_prim_lists(case, tmp_path):
    """The port's one-pass scan and JAX's per-level scan give the same
    prims (type, name, path, parent and body) on every ``.usda`` written,
    and on the text that the Crate reader makes of each ``.usdc``."""
    from kaolin_tpu.io.usd.crate import crate_to_usda
    for ext in ("usda", "usdc"):
        d = tmp_path / ext
        d.mkdir()
        EXPORTERS[case](JAX, str(d / f"a.{ext}"))
        path = str(d / f"a.{ext}")
        want = jcore._parse_usda(path)
        src = crate_to_usda(path) if ext == "usdc" else open(path).read()
        assert tcore._scan_prims(src) == want
        if ext == "usda":
            assert tcore._parse_usda(path) == want
        else:
            got = tcore._parse_usda(path)   # arrays stay arrays
            assert [{k: p[k] for k in ("type", "name", "path", "parent")}
                    for p in got] == [{k: p[k] for k in (
                        "type", "name", "path", "parent")} for p in want]


def test_importers_land_on_the_device_asked():
    """``device=None`` means the CUDA device: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tusd.import_mesh("unused.usda")


# -- the JAX faults the port does not copy -------------------------------------
def test_each_subset_gets_its_own_material_f33(tmp_path):
    """F33: JAX's ``get_mesh_prim_materials`` reads the file's first
    shader for every subset (``kaolin_tpu/io/usd/core.py:1178``); the port
    binds each subset to the material of its own name, and keeps JAX's
    answer where no material has the subset's name."""
    results = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        path = str(tmp_path / f"{name}.usda")
        stage = p.usd.create_stage(path)
        p.usd.add_mesh(stage, "/World/mesh", p.arr(V), p.arr(F))
        for sub, idx in (("front", np.arange(25)), ("back", np.arange(25,
                                                                      40)),
                         ("spare", np.arange(2))):
            p.usd.add_subset(stage, "/World/mesh", sub, p.arr(idx),
                             family_name="materialBind")
        for sub, color in (("front", (1.0, 0.0, 0.0)),
                           ("back", (0.0, 0.0, 1.0))):
            p.usd.write_usd_preview_surface(
                p.PBRMaterial(diffuse_color=color), stage,
                f"/World/Looks/{sub}")
        stage.save()
        results[name] = path
    want = jusd.get_mesh_prim_materials(results["jax"], "/World/mesh")
    got = tusd.get_mesh_prim_materials(results["port"], "/World/mesh",
                                       device="cpu")
    # JAX: "front" took the file's first shader, back's blue
    np.testing.assert_array_equal(np.asarray(want["front"].diffuse_color),
                                  [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(got["front"].diffuse_color.numpy(),
                                  [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(got["back"].diffuse_color.numpy(),
                                  [0.0, 0.0, 1.0])
    assert_same(got["spare"], want["spare"])     # no material of its name


LAYER_WITH_BRACES = '''#usda 1.0
(
    upAxis = "Y"
)

def Xform "World"
{
    string doc = "a } b {"
    asset readme = @notes/{draft}.txt@
    def Mesh "mesh"
    {
        int[] faceVertexCounts = [3]
        int[] faceVertexIndices = [0, 1, 2]
        point3f[] points = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        string label = "}"
    }
    def Points "cloud"
    {
        point3f[] points = [(0, 0, 1), (1, 1, 1)]
    }
}
'''


def test_braces_inside_strings_f34(tmp_path):
    """F34: JAX's brace scan counts braces inside strings and asset paths
    (``kaolin_tpu/io/usd/core.py:294-302``), so a string's ``}`` ends the
    prim: here JAX finds the World prim's body cut at the doc string and
    misses the points' cloud. The port skips them."""
    path = tmp_path / "braces.usda"
    path.write_text(LAYER_WITH_BRACES)
    jax_prims = jcore._parse_usda(str(path))
    port_prims = tcore._parse_usda(str(path))
    assert [p["path"] for p in port_prims] == ["/World", "/World/mesh",
                                               "/World/cloud"]
    assert [p["path"] for p in jax_prims] != ["/World", "/World/mesh",
                                              "/World/cloud"]
    assert 'string label = "}"' in port_prims[1]["body"]
    cloud = tusd.import_pointcloud(str(path), device="cpu")
    np.testing.assert_array_equal(cloud.points.numpy(),
                                  [[0, 0, 1], [1, 1, 1]])
    mesh = tusd.import_mesh(str(path), device="cpu")
    assert mesh.faces.tolist() == [[0, 1, 2]]


def test_point_cloud_with_normals_f35(tmp_path):
    """F35: JAX's ``_read_points_prim`` takes ``_aux("normals") or ...``
    of an array (``kaolin_tpu/io/usd/core.py:546``), which raises on a
    cloud whose normals are authored; the port returns them."""
    path = tmp_path / "normals.usda"
    path.write_text('#usda 1.0\ndef Points "cloud"\n{\n'
                    '    point3f[] points = [(0, 0, 1), (1, 1, 1)]\n'
                    '    normal3f[] normals = [(0, 0, 1), (0, 1, 0)]\n}\n')
    with pytest.raises(ValueError, match="ambiguous"):
        jusd.import_pointcloud(str(path))
    cloud = tusd.import_pointcloud(str(path), device="cpu")
    np.testing.assert_array_equal(cloud.normals.numpy(),
                                  [[0, 0, 1], [0, 1, 0]])


def test_usdc_transform_f36(tmp_path):
    """F36: a ``.usdc`` holds the transform as an array that JAX's
    ``get_local_to_world_transform`` (``kaolin_tpu/io/usd/core.py:1139``)
    does not parse: it reads identity. The port reads the matrix, as the
    ``.usda`` of the same stage gives it (``:g``'s rounding)."""
    for ext in ("usda", "usdc"):
        path = str(tmp_path / f"a.{ext}")
        _mesh(JAX, path)
        got = tusd.get_local_to_world_transform(path, "/World/mesh",
                                                device="cpu")
        np.testing.assert_array_equal(got.numpy(), XFORM.astype(F32))
        want = np.asarray(jusd.get_local_to_world_transform(path,
                                                            "/World/mesh"))
        np.testing.assert_array_equal(
            want, np.eye(4) if ext == "usdc" else XFORM.astype(F32))
    gpath = str(tmp_path / "g.usdc")
    _gaussians(JAX, gpath)
    assert tusd.get_local_to_world_transform(
        gpath, "/World/Gaussians/b", device="cpu").tolist() == \
        np.eye(4).tolist()


def test_usdc_material_keeps_colours_and_maps_f37(tmp_path):
    """F37: in a ``.usdc`` a colour is an array and a map's file a quoted
    asset; JAX's ``read_usd_preview_surface`` (``kaolin_tpu/io/usd/core.py:
    1047,1061``) reads neither, so the material loses them. The port reads
    both, and gives the ``.usda``'s material."""
    usda, usdc = str(tmp_path / "a.usda"), str(tmp_path / "a.usdc")
    _material_file(JAX, usda)
    _material_file(JAX, usdc)
    lost = jusd.import_material(usdc)
    assert lost.diffuse_color is None and lost.diffuse_texture is None
    assert_same(tusd.import_material(usdc, device="cpu"),
                jusd.import_material(usda))
    assert_same(tusd.import_material(_usdz(usdc), device="cpu"),
                jusd.import_material(usda))


def test_usda_text_holds_six_digits():
    """``:g`` keeps 6 significant digits, as the JAX package writes."""
    x = np.array([[1.23456789, -0.000123456789, 12345678.9]], F32)
    assert tcore._fmt_vec_array(x) == jcore._fmt_vec_array(x) == \
        "[(1.23457, -0.000123457, 1.23457e+07)]"
    assert re.fullmatch(r"\[[-\d, ]+\]", tcore._fmt_int_array(F[:2]))


def test_material_manager_dispatch_matches_jax(tmp_path):
    """An unknown shader reads as its raw inputs with a warning, a file
    without a shader raises MaterialNotFoundError, an unknown writer
    MaterialLoadError, and a registered reader and writer are used."""
    path = tmp_path / "custom.usda"
    path.write_text('#usda 1.0\ndef Shader "s"\n{\n'
                    '    uniform token info:id = "MyShader"\n'
                    '    float inputs:gain = 2.5\n}\n')
    binary = str(tmp_path / "custom.usdc")
    stage = jusd.create_stage(binary)
    prim = stage._get_prim("/World/s", "Shader")
    prim.set_attr("info:id", "token", '"MyShader"')
    prim.set_attr("inputs:tint", "color3f", "(0.5, 0.25, 1)")
    stage.save()
    for u in (jusd, tusd):
        with pytest.warns(UserWarning, match="No registered reader"):
            got = u.UsdMaterialIoManager.read_material(str(path))
        assert got == {"gain": "2.5"}
        with pytest.warns(UserWarning, match="No registered reader"):
            got = u.UsdMaterialIoManager.read_material(binary)
        assert got == {"tint": "[0.5, 0.25, 1.0]"}
        empty = tmp_path / f"{u.__name__}.usda"
        u.export_mesh(str(empty), vertices=V, faces=F)
        with pytest.raises(u.MaterialNotFoundError):
            u.UsdMaterialIoManager.read_material(str(empty))
        with pytest.raises(u.MaterialLoadError):
            u.UsdMaterialIoManager.write_material(None, None, "/x",
                                                  shader_name="Nope")
    seen = []
    tusd.UsdMaterialIoManager.register_usd_reader(
        "MyShader", lambda f, s, t: seen.append((s, t)) or "mine")
    try:
        assert tusd.UsdMaterialIoManager.read_material(
            str(path), "/s", 3.0) == "mine"
        assert seen == [("/s", 3.0)]
        with pytest.warns(UserWarning, match="already registered"):
            tusd.UsdMaterialIoManager.register_usd_reader(
                "MyShader", lambda f, s, t: None)
        with pytest.raises(TypeError):
            tusd.UsdMaterialIoManager.register_usd_writer("MyShader", 3)
    finally:
        tusd.UsdMaterialIoManager._usd_readers.pop("MyShader")


def test_examples_run_on_the_cpu():
    """``examples/torch_tutorial_usd_scene.py`` at the JAX tutorial's size
    and ``examples/torch_usd_asset.py`` at its smoke size pass their own
    checks on the CPU."""
    from tests.torch_parity import load_example
    out = load_example("torch_tutorial_usd_scene").main("cpu")
    assert out == {"prims": 5, "formats": "usda+usdc"}
    ex = load_example("torch_usd_asset")
    res = ex.main("cpu", smoke=True, verbose=False)
    assert res["ok"]
    assert res["turntable"].canvas.last_image.shape == (64, 64, 3)
