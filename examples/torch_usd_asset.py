"""An asset through USD with kaolin_tpu_torch: the textured 81,408-face
mesh written and read as ``.usda`` and ``.usdc`` and rendered at 512², 2^20
gaussians through a ``.usdc``, a fit logged by ``Timelapse`` and served as
dash3d's wire bytes, the Jupyter turntable driven by events, and the native
``check_sign``.

- **The asset** (:func:`write_usd`, :func:`import_usd`).
  ``torch_asset_render.py``'s 160 x 256 UV sphere (81,408 faces sorted by
  material, 1,024² maps) written by ``io.usd`` as ``.usda`` and as
  ``.usdc``: ``add_mesh`` with ``uvs`` and ``face_uvs_idx``, two
  ``materialBind`` subsets (``add_subset``), two UsdPreviewSurface
  materials under ``/World/Looks/<subset>`` (``write_usd_preview_surface``,
  their maps as PNGs beside the file), and a
  ``set_local_to_world_transform``. Read back through the dispatcher
  ``io.import_mesh``, ``import_subsets`` and ``get_mesh_prim_materials``
  onto the device, and assembled into the render's ``SurfaceMesh`` as
  ``torch_asset_render.import_asset`` assembles the OBJ's.
- **Render** (:func:`render`): ``render_mesh(default_camera(512), mesh,
  default_lighting())``; on the card it launches the winner-search kernel
  once.
- **Gaussians** (:func:`gaussian_round_trip`): 2^20 seeded gaussians at SH
  degree 3 through ``usd.export_gaussiancloud`` to a ``.usdc`` and back
  through ``io.import_gaussiancloud``.
- **Timelapse** (:func:`log_fit`, :func:`wire_bytes`): the 100-step fit of
  ``torch_easy_render.py`` logged by ``Timelapse.add_mesh_batch`` every 10
  steps (11 checkpoints) with 4,096 points sampled from the mesh
  (``add_pointcloud_batch``), read back by ``TimelapseParser``, and the
  last checkpoint encoded by dash3d's ``StreamingGeometryHelper`` (no
  server starts).
- **Turntable** (:func:`turntable`, :data:`EVENTS`): an
  ``IpyTurntableVisualizer`` at 512², headless, whose ``render`` is
  ``render_mesh`` of the ``.usdc`` import; the events drag, pan and zoom
  it, 16 renders.
- **check_sign** (:func:`native_check_sign`): ``backend="native"`` (the
  host C++ TriangleHash) against the device's ray parity on
  ``torch_simplicits_train.py``'s torus and its 100,000 candidates.

Everything lands on the CUDA device unless ``cpu`` is named; ``smoke`` runs
every part at a small size (a 24 x 32 sphere, 64² renders):

    PYTHONPATH=. python examples/torch_usd_asset.py [cuda|cpu] [smoke]
"""

import functools
import importlib.util
import os
import sys
import tempfile

import numpy as np
import torch

from kaolin_tpu_torch import io as kio
from kaolin_tpu_torch.experimental.dash3d import StreamingGeometryHelper
from kaolin_tpu_torch.io import usd
from kaolin_tpu_torch.io.utils import TextureExporter
from kaolin_tpu_torch.ops.mesh import check_sign, sample_points
from kaolin_tpu_torch.render.easy_render import default_camera
from kaolin_tpu_torch.render.materials import PBRMaterial
from kaolin_tpu_torch.rep import SurfaceMesh
from kaolin_tpu_torch.utils.backend import resolve_device
from kaolin_tpu_torch.visualize import (IpyTurntableVisualizer, Timelapse,
                                        TimelapseParser)

ASSET = (160, 256)            # 81,408 faces
TEX = 1024
RES = 512
GAUSSIANS = 1 << 20
FIT_STEPS = 100
LOG_EVERY = 10                # 11 checkpoints
CLOUD = 4096
SMOKE = dict(asset=(24, 32), tex=64, res=64, gaussians=4096, steps=10,
             log_every=5, candidates=4096)
MESH_PATH = "/World/asset"
SUBSETS = ("checker", "metal")    # the subsets and their materials, in order
TRANSFORM = ((1.5, 0.0, 0.0, 0.0), (0.0, 1.5, 0.0, 0.0),
             (0.0, 0.0, 1.5, 0.0), (0.25, -0.125, 0.0625, 1.0))
# the turntable's events, as tests/render/test_ipython_viz.py sends them:
# a left drag (orbit), a right drag (pan) and wheels (zoom; ctrl: dolly);
# the two presses render nothing, the other 16 events one frame each
EVENTS = (
    [{"type": "mousedown", "relativeX": 256, "relativeY": 256}]
    + [{"type": "mousemove", "buttons": 1, "relativeX": 256 + 24 * k,
        "relativeY": 256 - 8 * k} for k in range(1, 7)]
    + [{"type": "mouseup"},
       {"type": "mousedown", "relativeX": 300, "relativeY": 200}]
    + [{"type": "mousemove", "buttons": 2, "relativeX": 300 - 10 * k,
        "relativeY": 200 + 6 * k} for k in range(1, 5)]
    + [{"type": "mouseup"}]
    + [{"type": "wheel", "deltaY": d, "ctrlKey": c}
       for d, c in ((-120, False), (-240, False), (200, True), (-100, True))])
RENDERS = 16


@functools.cache
def _sibling(name):
    """``examples/<name>.py`` as a module, loaded once a process."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def asset_arrays(size=ASSET, tex=TEX):
    """``torch_asset_render.asset_arrays``: the asset as numpy arrays."""
    return _sibling("torch_asset_render").asset_arrays(size, tex)


def materials(a):
    """The two materials written, HWC maps as the writer and the reader
    hold them: a specular checker (its diffuse map) and a metal (its
    roughness map)."""
    ex = _sibling("torch_asset_render")
    return [PBRMaterial(material_name=SUBSETS[0], is_specular_workflow=True,
                        diffuse_color=ex.KD[0], specular_color=ex.KS[0],
                        roughness_value=0.35, diffuse_texture=a["checker"]),
            PBRMaterial(material_name=SUBSETS[1], diffuse_color=ex.KD[1],
                        metallic_value=0.7,
                        roughness_texture=a["metal_rough"][..., 1:2])]


def write_usd(path, a):
    """Write the asset (:func:`asset_arrays`' arrays, or tensors of them on
    any device) to ``path`` (``.usda`` text or ``.usdc`` binary by its
    extension), the maps as PNGs under ``textures/`` beside it →
    ``path``."""
    stage = usd.create_stage(path)
    usd.add_mesh(stage, MESH_PATH, a["vertices"], a["faces"], uvs=a["uvs"],
                 face_uvs_idx=a["face_uvs_idx"])
    assign = torch.as_tensor(a["material_assignments"]).cpu().numpy()
    for i, name in enumerate(SUBSETS):
        usd.add_subset(stage, MESH_PATH, name, np.nonzero(assign == i)[0],
                       family_name="materialBind")
    exporter = TextureExporter(os.path.dirname(os.path.abspath(path)))
    for name, mat in zip(SUBSETS, materials(a)):
        usd.write_usd_preview_surface(mat, stage, f"/World/Looks/{name}",
                                      exporter)
    usd.set_local_to_world_transform(stage, MESH_PATH, np.asarray(TRANSFORM))
    stage.save()
    return path


def _chw(material):
    """A material read from USD (HWC maps; one channel as (H, W)) with its
    maps CHW, as ``render_mesh`` samples them."""
    out = material.chw()
    for name in PBRMaterial.supported_texture_attributes():
        t = getattr(out, name)
        if t is not None and t.ndim == 2:
            setattr(out, name, t[None])
    return out


def import_usd(path, device=None):
    """The asset from a USD file on ``device`` (the CUDA device unless
    named): ``io.import_mesh``, the subsets as ``material_assignments``
    and each subset's material → (SurfaceMesh, its local-to-world
    transform)."""
    device = resolve_device(device, "import_usd")
    mesh = kio.import_mesh(path, device=device)
    subsets = usd.import_subsets(path, MESH_PATH, "materialBind",
                                 device=device)
    bound = usd.get_mesh_prim_materials(path, MESH_PATH, device=device)
    assign = torch.zeros(mesh.faces.shape[0], dtype=torch.int64,
                         device=device)
    for i, name in enumerate(SUBSETS):
        assign[subsets[name]["indices"]] = i
    out = SurfaceMesh(vertices=mesh.vertices, faces=mesh.faces, uvs=mesh.uvs,
                      face_uvs_idx=mesh.face_uvs_idx,
                      material_assignments=assign,
                      materials=[_chw(bound[name]) for name in SUBSETS])
    return out, usd.get_local_to_world_transform(path, MESH_PATH,
                                                 device=device)


def render(mesh, res=RES):
    """``render_mesh(default_camera(res), mesh, default_lighting())`` on
    the mesh's device → the passes."""
    return _sibling("torch_easy_render").render(mesh, res=res)


def gaussian_round_trip(directory, n=GAUSSIANS, device=None, seed=0):
    """``n`` seeded gaussians at SH degree 3 written by
    ``usd.export_gaussiancloud`` to a ``.usdc`` and read back by
    ``io.import_gaussiancloud`` on ``device`` → (the arrays written, the
    GaussianSplatModel read, the file's path)."""
    device = resolve_device(device, "gaussian_round_trip")
    g = _sibling("torch_asset_render")._random_gaussians(n, seed)
    path = os.path.join(directory, "gaussians.usdc")
    usd.export_gaussiancloud(path, g["positions"], g["orientations"],
                             g["scales"], g["opacities"], g["sh_coeff"])
    return g, kio.import_gaussiancloud(path, device=device), path


def log_fit(logdir, device=None, res=RES, steps=FIT_STEPS,
            log_every=LOG_EVERY, seed=0):
    """``torch_easy_render.py``'s fit for ``steps`` steps on ``device``,
    its mesh logged into ``logdir`` by ``Timelapse.add_mesh_batch`` (category
    ``fit``) before the first step and every ``log_every`` steps, with
    ``CLOUD`` points sampled from it (``add_pointcloud_batch``, category
    ``samples``) → dict of the checkpoints' vertices and points (as
    logged), the faces, the losses."""
    device = resolve_device(device, "log_fit")
    ex = _sibling("torch_easy_render")
    state = ex.fit_setup(device, res=res)
    faces = state["mesh"].faces
    gen = torch.Generator(device=device).manual_seed(seed)
    timelapse = Timelapse(logdir)
    logged, clouds, losses = [], [], []
    for it in range(steps + 1):
        if it % log_every == 0:
            verts = (state["template"] + state["params"]["offsets"]).detach()
            points, _ = sample_points(verts[None], faces, CLOUD,
                                      generator=gen)
            timelapse.add_mesh_batch(iteration=it, category="fit",
                                     vertices_list=[verts],
                                     faces_list=[faces])
            timelapse.add_pointcloud_batch(iteration=it, category="samples",
                                           pointcloud_list=[points[0]])
            logged.append(verts)
            clouds.append(points[0])
        if it < steps:
            losses.append(float(ex.fit_step(state)))
    return {"vertices": logged, "points": clouds, "faces": faces,
            "losses": losses}


def wire_bytes(logdir):
    """The last checkpoint as dash3d sends it: the parser's listing, and
    ``StreamingGeometryHelper``'s framed mesh and point-cloud messages at
    the latest time → (listing, mesh bytes, cloud bytes)."""
    helper = StreamingGeometryHelper(logdir)
    listing = helper.get_directory_info()

    def request(kind, category):
        return helper.get_requested_geometry(
            {"type": kind, "category": category, "id": 0, "time": 1e9,
             "view_id": 0})

    return listing, request("mesh", "fit"), request("pointcloud", "samples")


def turntable(mesh, res=RES):
    """A headless ``IpyTurntableVisualizer`` at ``res``² whose render is
    ``render_mesh`` of ``mesh`` under ``default_lighting()`` → the
    visualizer (its frames: 8-bit (res, res, 3) images on the host)."""
    from kaolin_tpu_torch.render.easy_render import (default_lighting,
                                                     render_mesh)
    device = mesh.vertices.device
    lighting = default_lighting(device)

    def frame(camera):
        with torch.no_grad():
            img = render_mesh(camera, mesh, lighting)["render"][0]
        return {"img": (img.clamp(0.0, 1.0) * 255).to(torch.uint8)}

    return IpyTurntableVisualizer(res, res, default_camera(res, device),
                                  frame)


def drive(viz, events=EVENTS):
    """Send the events to the visualizer → the visualizer."""
    for event in events:
        viz._handle_event(event)
    return viz


def native_check_sign(device=None, num=None):
    """``check_sign`` of ``torch_simplicits_train.py``'s torus and its
    candidates (100,000 unless ``num``) on ``device``, with
    ``backend="native"`` and without → (native, device), (N,) bool each on
    ``device``."""
    device = resolve_device(device, "native_check_sign")
    ex = _sibling("torch_simplicits_train")
    verts, faces = ex.torus_mesh(device=device)
    pts = ex.candidates(verts, num or ex.CANDIDATES, seed=0)
    return (check_sign(verts[None], faces, pts[None], backend="native")[0],
            check_sign(verts[None], faces, pts[None])[0])


def main(device=None, smoke=False, verbose=True):
    """Every part above on ``device`` (the CUDA device unless named), at
    full size or at the ``SMOKE`` sizes → dict of the results."""
    device = resolve_device(device, "main")
    s = SMOKE if smoke else dict(asset=ASSET, tex=TEX, res=RES,
                                 gaussians=GAUSSIANS, steps=FIT_STEPS,
                                 log_every=LOG_EVERY, candidates=None)
    a = asset_arrays(s["asset"], s["tex"])
    with tempfile.TemporaryDirectory() as d:
        meshes, transforms = {}, {}
        for ext in ("usda", "usdc"):
            path = write_usd(os.path.join(d, ext, f"asset.{ext}"), a)
            meshes[ext], transforms[ext] = import_usd(path, device)
        passes = render(meshes["usdc"], s["res"])
        g, back, _ = gaussian_round_trip(d, s["gaussians"], device)
        fit = log_fit(os.path.join(d, "log"), device, s["res"], s["steps"],
                      s["log_every"])
        parser = TimelapseParser(os.path.join(d, "log"))
        listing, mesh_msg, cloud_msg = wire_bytes(os.path.join(d, "log"))
    viz = drive(turntable(meshes["usdc"], s["res"]))
    inside_native, inside = native_check_sign(device, s["candidates"])
    exact = torch.equal(meshes["usdc"].vertices.cpu(),
                        torch.from_numpy(a["vertices"]))
    near = torch.allclose(meshes["usda"].vertices.cpu(),
                          torch.from_numpy(a["vertices"]), rtol=5e-6,
                          atol=1e-7)
    round_trip = all(np.array_equal(getattr(back, k).cpu().numpy(), want)
                     for k, want in (("positions", g["positions"]),
                                     ("scales", g["scales"]),
                                     ("opacities", g["opacities"])))
    ok = (exact and near and round_trip
          and bool(torch.isfinite(passes["render"]).all())
          and int((passes["face_idx"] >= 0).sum()) > 0
          and parser.num_mesh_items() == 1 and mesh_msg is not None
          and cloud_msg is not None and fit["losses"][-1] < fit["losses"][0]
          and viz.canvas.last_image is not None
          and bool(inside_native.any()))
    if verbose:
        print(f"usd asset: {int(meshes['usdc'].faces.shape[0])} faces, "
              f"usdc bit for bit {exact}, usda within :g {near}; render at "
              f"{s['res']}² covers "
              f"{int((passes['face_idx'] >= 0).sum())} pixels; "
              f"{s['gaussians']} gaussians round trip {round_trip}; fit "
              f"loss {fit['losses'][0]:.5f} -> {fit['losses'][-1]:.5f}, "
              f"{len(fit['vertices'])} checkpoints, wire bytes "
              f"{len(mesh_msg)} + {len(cloud_msg)}; check_sign native "
              f"differs at {int((inside_native != inside).sum())} of "
              f"{inside.numel()} (rounding may part candidates within "
              f"1e-5 of the surface); ok {ok}", flush=True)
    return {"meshes": meshes, "transforms": transforms, "passes": passes,
            "gaussians": (g, back), "fit": fit, "listing": listing,
            "wire": (mesh_msg, cloud_msg), "turntable": viz,
            "check_sign": (inside_native, inside), "ok": ok}


if __name__ == "__main__":
    args = sys.argv[1:]
    out = main(next((x for x in args if x != "smoke"), None),
               smoke="smoke" in args)
    sys.exit(0 if out["ok"] else 1)
