"""kaolin_tpu_torch.visualize and experimental.dash3d against kaolin_tpu's,
on the CPU.

- ``Timelapse``: mesh, point-cloud (with colours) and voxelgrid batches over
  several iterations write the JAX package's files byte for byte from
  tensors; ``TimelapseParser`` gives JAX's listings, also of binary
  (``.usdc``) checkpoints.
- dash3d: ``meshes_to_binary``, ``point_clouds_to_binary`` and
  ``StreamingGeometryHelper``'s framed messages (snap, dedup, malformed
  requests) equal JAX's bytes; one tornado server answers a page request
  and a websocket geometry request on localhost.
- The Jupyter visualizers (headless): turntable and first-person event
  sequences give JAX's cameras within 1e-6 of max|x|; the quaternion
  helpers equal JAX's within 1e-6.
"""

import asyncio
import json
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.experimental.dash3d as jdash
import kaolin_tpu.visualize as jvis
import kaolin_tpu.visualize.ipython as jipy
import kaolin_tpu_torch.experimental.dash3d as tdash
import kaolin_tpu_torch.visualize as tvis
import kaolin_tpu_torch.visualize.ipython as tipy
from kaolin_tpu.render.camera import Camera as JCamera
from kaolin_tpu_torch.render.camera import Camera as TCamera
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

RNG = np.random.RandomState(0)
CAMERA_TOL = 1e-6


def _sphere(r=1.0, n_lat=6, n_lon=8):
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = r * np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                      np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return v.astype(np.float32), np.asarray(faces, np.int32)


def _log(vis, logdir, arr):
    """Three iterations of meshes (two at once), point clouds with colours
    and voxelgrids through ``vis.Timelapse``; ``arr`` turns numpy into the
    package's inputs."""
    tl = vis.Timelapse(logdir)
    for it, r in ((0, 1.0), (50, 1.25), (100, 1.5)):
        v, f = _sphere(r)
        tl.add_mesh_batch(iteration=it, category="opt",
                          vertices_list=[arr(v), arr(v * 0.5)],
                          faces_list=[arr(f), arr(f)])
        tl.add_pointcloud_batch(iteration=it, category="pc",
                                pointcloud_list=arr(np.stack([v, v[::-1]])),
                                colors=[arr(np.abs(v)), arr(np.abs(v) / 2)])
        tl.add_voxelgrid_batch(iteration=it, category="vox",
                               voxelgrid_list=[arr(RNG.rand(4, 4, 4) > r
                                                   / 3)])
    return logdir


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("timelapse")
    state = RNG.get_state()
    jax_dir = _log(jvis, str(d / "jax"), lambda x: x)
    RNG.set_state(state)
    port_dir = _log(tvis, str(d / "port"), torch.as_tensor)
    return jax_dir, port_dir


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_timelapse_writes_jax_bytes(logs):
    jax_dir, port_dir = logs
    files = _tree(jax_dir)
    assert files == _tree(port_dir) and len(files) == 5
    for name in files:
        with open(os.path.join(jax_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def _relative(info, root):
    """A parser's ``dir_info`` with its paths relative to ``root``."""
    return {t: {c: {i: dict(e, path=os.path.relpath(e["path"], root))
                    for i, e in ids.items()} for c, ids in cats.items()}
            for t, cats in info.items()}


def test_parser_listings_match_jax(logs):
    jax_dir, port_dir = logs
    j, t = jvis.TimelapseParser(jax_dir), tvis.TimelapseParser(port_dir)
    assert _relative(t.dir_info, port_dir) == _relative(j.dir_info, jax_dir)
    assert t.serializable() == j.serializable()
    for typ in ("mesh", "pointcloud", "voxelgrid", "nope"):
        assert t.get_category_names_by_type(typ) == \
            j.get_category_names_by_type(typ)
    for typ, cat in (("mesh", "opt"), ("pointcloud", "pc"), ("mesh", "x")):
        ti, ji = t.get_category_info(typ, cat), j.get_category_info(typ, cat)
        if ji is None:
            assert ti is None
        else:
            assert {k: v for k, v in ti.items() if k != "paths"} == \
                {k: v for k, v in ji.items() if k != "paths"}
    assert [t.num_mesh_items(), t.num_pointcloud_items(),
            t.num_voxelgrid_items(), t.num_mesh_categories()] == \
        [j.num_mesh_items(), j.num_pointcloud_items(),
         j.num_voxelgrid_items(), j.num_mesh_categories()] == [2, 2, 1, 1]
    assert sorted(t.get_filepaths(port_dir)) == \
        sorted(j.get_filepaths(jax_dir))
    assert t.parse_filepath_info(t.get_filepaths(port_dir)) == \
        j.parse_filepath_info(j.get_filepaths(jax_dir))
    assert not t.check_for_updates()


def test_parser_reads_binary_checkpoints(tmp_path):
    """A checkpoint written as ``.usdc`` (as stock USD tools write) lists
    its time samples as JAX's parser lists them."""
    import kaolin_tpu.io.usd as jusd
    v, f = _sphere()
    path = str(tmp_path / "mesh_0.usdc")
    stage = jusd.create_stage(path)
    for t in (0, 10, 20):
        jusd.add_mesh(stage, "/mesh_0", v * (1 + t / 10), f if t == 0
                      else None, time=t)
    stage.save()
    assert tvis.TimelapseParser._get_timestamps(path) == \
        jvis.TimelapseParser._get_timestamps(path) == [0.0, 10.0, 20.0]


# -- dash3d ---------------------------------------------------------------------
def test_wire_format_matches_jax():
    v1, f1 = _sphere(1.0, 5, 7)
    v2, f2 = _sphere(0.5, 8, 6)
    assert tdash.meshes_to_binary(
        [torch.from_numpy(v1), torch.from_numpy(v2)],
        [torch.from_numpy(f1), f2]) == jdash.meshes_to_binary([v1, v2],
                                                             [f1, f2])
    assert tdash.point_clouds_to_binary([torch.from_numpy(v1), v2]) == \
        jdash.point_clouds_to_binary([v1, v2])
    with pytest.raises(RuntimeError, match="equal number"):
        tdash.meshes_to_binary([v1], [])


REQUESTS = [
    {"type": "mesh", "category": "opt", "id": 0, "time": 1e9, "view_id": 3},
    {"type": "mesh", "category": "opt", "id": 1, "time": 49, "view_id": 0},
    {"type": "mesh", "category": "opt", "id": 0, "time": 100, "view_id": 0,
     "current_time": 100},
    {"type": "pointcloud", "category": "pc", "id": 1, "time": 0,
     "view_id": 1},
    {"type": "mesh", "category": "nope", "id": 9, "time": 0, "view_id": 0},
    {"type": "voxelgrid", "category": "vox", "id": 0, "time": 0,
     "view_id": 0},
    {"type": "mesh"},
]


def test_streaming_helper_matches_jax(logs):
    jax_dir, port_dir = logs
    j = jdash.StreamingGeometryHelper(jax_dir)
    t = tdash.StreamingGeometryHelper(port_dir)
    assert json.loads(t.get_directory_info()) == \
        json.loads(j.get_directory_info())
    for req in REQUESTS:
        assert t.get_requested_geometry(req) == \
            j.get_requested_geometry(req), req
    assert t.get_requested_geometry(REQUESTS[0])[:16] == struct.pack(
        "<4i", 0, 3, 100, 0)


def test_tornado_answers_a_page_and_a_geometry_request(logs):
    """One server on localhost: the index page lists the checkpoints; the
    websocket sends the directory, then the geometry that the helper
    encodes for the request."""
    tornado = pytest.importorskip("tornado")
    from tornado.httpclient import AsyncHTTPClient
    from tornado.httpserver import HTTPServer
    from tornado.testing import bind_unused_port
    from tornado.websocket import websocket_connect
    assert tornado.version_info >= (6,)
    _, port_dir = logs

    async def exchange():
        sock, port = bind_unused_port()
        server = HTTPServer(tdash.create_server(port_dir))
        server.add_sockets([sock])
        try:
            page = await AsyncHTTPClient().fetch(f"http://127.0.0.1:{port}/")
            ws = await websocket_connect(f"ws://127.0.0.1:{port}/websocket/")
            first = await ws.read_message()
            await ws.write_message(json.dumps(
                {"type": "geometry", "data": [REQUESTS[0]]}))
            geometry = await ws.read_message()
            ws.close()
        finally:
            server.stop()
        return page, first, geometry

    page, first, geometry = asyncio.run(exchange())
    assert page.code == 200 and b"dash3d" in page.body
    assert json.loads(first)["type"] == "dirinfo"
    assert geometry == tdash.StreamingGeometryHelper(
        port_dir).get_requested_geometry(REQUESTS[0])


def test_dash3d_imports_tornado_at_first_use():
    code = ("import sys\n"
            "import kaolin_tpu_torch.experimental.dash3d as d\n"
            "assert 'tornado' not in sys.modules\n"
            "assert d.GeometryWebSocketHandler is not None\n"
            "assert 'tornado' in sys.modules\n")
    import subprocess
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))


# -- the Jupyter visualizers ----------------------------------------------------
def _cameras():
    kw = dict(fov=np.deg2rad(45.0), width=32, height=32)
    return (JCamera.from_args(eye=jnp.asarray([0.0, 1.0, 3.0]),
                              at=jnp.zeros(3),
                              up=jnp.asarray([0.0, 1.0, 0.0]), **kw),
            TCamera.from_args(eye=torch.tensor([0.0, 1.0, 3.0]),
                              at=torch.zeros(3),
                              up=torch.tensor([0.0, 1.0, 0.0]), **kw))


def _render(camera):
    img = np.zeros((32, 32, 3), np.uint8)
    img[..., 0] = np.uint8(abs(float(np.asarray(camera.cam_pos()).reshape(
        -1)[0])) * 10 % 255)
    return {"img": img, "depth": np.full((32, 32), 2.0, np.float32)}


def _camera_err(t, j):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               / max(float(np.abs(np.asarray(a)).max()), 1.0)
               for a, b in ((j.view_matrix(), t.view_matrix()),
                            (j.intrinsics.params, t.intrinsics.params)))


DRAG = [{"type": "mousedown", "relativeX": 0, "relativeY": 0}] + [
    {"type": "mousemove", "buttons": 1, "relativeX": 4 * k,
     "relativeY": -3 * k} for k in range(1, 6)] + [{"type": "mouseup"}]
TURNTABLE_EVENTS = DRAG + [
    {"type": "mousedown", "relativeX": 10, "relativeY": 10},
    {"type": "mousemove", "buttons": 2, "relativeX": 14, "relativeY": 7},
    {"type": "mousemove", "buttons": 3, "relativeX": 1, "relativeY": 1},
    {"type": "mouseleave"},
    {"type": "wheel", "deltaY": -300, "ctrlKey": False},
    {"type": "wheel", "deltaY": 300, "ctrlKey": True},
    {"type": "mousedown", "relativeX": 0, "relativeY": 0},
    {"type": "mousemove", "buttons": 1, "relativeX": 0, "relativeY": 40},
    {"type": "mousemove", "buttons": 1, "relativeX": 0, "relativeY": 80}]
FPS_EVENTS = [{"type": "keydown", "key": k} for k in "ouijklq"] + DRAG + [
    {"type": "wheel", "deltaY": -200},
    {"type": "mousedown", "relativeX": 10, "relativeY": 0}] + [
    {"type": "mousemove", "buttons": 1, "relativeX": 10 + k,
     "relativeY": -2 * k} for k in range(1, 8)]
# a drag far up, to the elevation's clamp 1e-3 from the pole: there the
# view direction's horizontal part is a difference of nearly equal numbers,
# which magnifies float32 rounding about 1,000-fold, so the cameras are held
# within 1e-3 (the elevation within 1e-6)
CLAMP = {"type": "mousemove", "buttons": 1, "relativeX": 20,
         "relativeY": -400}
CLAMP_TOL = 1e-3


@pytest.mark.parametrize("kind", ["turntable", "turntable_z_up",
                                  "first_person", "first_person_up"])
def test_event_sequences_give_jax_cameras(kind):
    jc, tc = _cameras()
    if kind.startswith("turntable"):
        kw = dict(world_up_axis=2, focus_at=(0.1, 0.0, -0.2)) \
            if kind.endswith("z_up") else {}
        j = jipy.IpyTurntableVisualizer(32, 32, jc, _render, **kw)
        t = tipy.IpyTurntableVisualizer(32, 32, tc, _render, **kw)
        events = TURNTABLE_EVENTS
    else:
        kw = dict(world_up=(0.0, 1.0, 0.2)) if kind.endswith("up") else {}
        j = jipy.IpyFirstPersonVisualizer(32, 32, jc, _render, **kw)
        t = tipy.IpyFirstPersonVisualizer(32, 32, tc, _render, **kw)
        events = FPS_EVENTS
    assert _camera_err(t.camera, j.camera) <= CAMERA_TOL
    for i, event in enumerate(events):
        j._handle_event(event)
        t._handle_event(event)
        assert _camera_err(t.camera, j.camera) <= CAMERA_TOL, (i, event)
        assert t.elevation == pytest.approx(j.elevation, abs=1e-6)
        assert t.azimuth == pytest.approx(j.azimuth, abs=1e-6)
    if not kind.startswith("turntable"):
        j._handle_event(CLAMP)
        t._handle_event(CLAMP)
        assert t.elevation == pytest.approx(j.elevation, abs=1e-6)
        assert abs(t.elevation) == pytest.approx(np.pi / 2 - 1e-3)
        assert _camera_err(t.camera, j.camera) <= CLAMP_TOL
    np.testing.assert_array_equal(t.canvas.last_image, j.canvas.last_image)
    under = {"relativeX": 16, "relativeY": 16, "boundingRectWidth": 32,
             "boundingRectHeight": 32}
    got, want = t.get_values_under_cursor(under), \
        j.get_values_under_cursor(under)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_quaternion_helpers_match_jax():
    for angle, axis, point in ((np.pi / 2, (0.0, 0.0, 1.0), (1.0, 0, 0)),
                               (0.7, (1.0, 2.0, 3.0), (0.3, -0.4, 2.0)),
                               (-2.5, (0.0, 1.0, 0.0), (1.0, 1.0, 1.0))):
        q_t = tipy.make_quaternion_rotation(angle, torch.tensor(axis))
        q_j = jipy.make_quaternion_rotation(angle, jnp.asarray(axis))
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-6)
        for t_out, j_out in (
                (tipy.rotate_around_axis(torch.tensor(point), angle,
                                         torch.tensor(axis)),
                 jipy.rotate_around_axis(jnp.asarray(point), angle,
                                         jnp.asarray(axis))),
                (tipy.mulqq(q_t, tipy.conjugate(q_t)),
                 jipy.mulqq(q_j, jipy.conjugate(q_j))),
                (tipy.mulqv(q_t, torch.tensor(point)),
                 jipy.mulqv(q_j, jnp.asarray(point)))):
            assert t_out.dtype == torch.float32
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                       atol=1e-6)


def test_headless_canvas_and_show():
    _, tc = _cameras()
    viz = tipy.IpyTurntableVisualizer(32, 32, tc, lambda c: torch.ones(
        32, 32, 3, dtype=torch.uint8))
    viz.render_update()
    assert viz.canvas.last_image.shape == (32, 32, 3)
    viz.fast_render_update()
    with pytest.raises(ImportError, match="ipycanvas"):
        viz.show()
    canvas = tipy._HeadlessCanvas(4, 4)
    tipy.update_canvas(canvas, torch.zeros(4, 4, 3))
    assert isinstance(canvas.last_image, np.ndarray)
