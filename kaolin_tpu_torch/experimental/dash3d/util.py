"""Dash3D geometry streaming: binary wire format + websocket handler.

Counterpart of ``kaolin_tpu/experimental/dash3d/util.py`` (reference
``kaolin/experimental/dash3d/util.py``: meshes_to_binary :28,
point_clouds_to_binary :64, StreamingGeometryHelper :92,
GeometryWebSocketHandler :220). Wire format is byte-identical to the
reference so clients interoperate. Tensors on any device are encoded from
the host; the USD checkpoints are read onto the CPU.
"""

import json
import logging

import numpy as np

from kaolin_tpu_torch.io.utils import _host
from kaolin_tpu_torch.visualize.timelapse import TimelapseParser

logger = logging.getLogger(__name__)

__all__ = ["meshes_to_binary", "point_clouds_to_binary",
           "StreamingGeometryHelper", "GeometryWebSocketHandler"]


def meshes_to_binary(vertices_list, faces_list):
    """Encode meshes for network transfer. Ref :28.

    Layout: int32[4] header (nmeshes, texture_mode, 0, 0); per mesh
    int32[2] (nvertices, nfaces) + float32 vertices + int32 faces.
    """
    nmeshes = len(vertices_list)
    if len(faces_list) != nmeshes:
        raise RuntimeError(
            f"Expected equal number of vertex and face lists, got: "
            f"{nmeshes}, {len(faces_list)}")
    binstr = np.array([nmeshes, 0, 0, 0], dtype=np.int32).tobytes()
    for vertices, faces in zip(vertices_list, faces_list):
        vertices = _host(vertices)
        faces = _host(faces)
        binstr += np.array([vertices.size // 3, faces.size // 3],
                           dtype=np.int32).tobytes()
        binstr += vertices.astype(np.float32).tobytes()
        binstr += faces.astype(np.int32).tobytes()
    return binstr


def point_clouds_to_binary(positions_list):
    """Encode point clouds for network transfer. Ref :64.

    Layout: int32[4] header (nclouds, texture_mode, 0, 0); per cloud
    int32[2] (npts, 0) + float32[6] bbox(min, max) + float32 positions.
    """
    nclouds = len(positions_list)
    binstr = np.array([nclouds, 0, 0, 0], dtype=np.int32).tobytes()
    for positions in positions_list:
        positions = _host(positions)
        binstr += np.array([positions.size // 3, 0], dtype=np.int32).tobytes()
        binstr += np.min(positions, axis=0).astype(np.float32).tobytes()
        binstr += np.max(positions, axis=0).astype(np.float32).tobytes()
        binstr += positions.astype(np.float32).tobytes()
    return binstr


class StreamingGeometryHelper:
    """Parses Timelapse USD checkpoints and encodes geometry updates. Ref :92."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.parser = TimelapseParser(logdir)

    def get_directory_info(self):
        self.parser.check_for_updates()
        return self.parser.serializable()

    @staticmethod
    def _find_snap_time(times, target_time):
        """Closest available timestamp to target_time. Ref :104."""
        if not times:
            return 0
        return min(times, key=lambda t: abs(t - target_time))

    @staticmethod
    def _does_snap_time_require_update(snap_time, current_time):
        """Ref :117."""
        if current_time is not None and abs(snap_time - current_time) < 0.5:
            return False
        return True

    def _entry(self, typ, category, idx):
        try:
            return self.parser.dir_info[typ][category][idx]
        except KeyError:
            return None

    def parse_encode_pointcloud(self, category, id, target_time,
                                current_time=None):
        """Ref :142. Returns (binary or None, snap_time)."""
        from kaolin_tpu_torch.io import usd
        entry = self._entry("pointcloud", category, id)
        if entry is None:
            return None, 0
        snap_time = self._find_snap_time(entry["times"], target_time)
        if not self._does_snap_time_require_update(snap_time, current_time):
            return None, current_time
        points = usd.import_pointcloud(entry["path"], time=snap_time,
                                       device="cpu").points
        return point_clouds_to_binary([points]), snap_time

    def parse_encode_mesh(self, category, id, target_time, current_time=None):
        """Ref :177. Returns (binary or None, snap_time)."""
        from kaolin_tpu_torch.io import usd
        entry = self._entry("mesh", category, id)
        if entry is None:
            return None, 0
        snap_time = self._find_snap_time(entry["times"], target_time)
        if not self._does_snap_time_require_update(snap_time, current_time):
            return None, current_time
        mesh = usd.import_mesh(entry["path"], time=snap_time, device="cpu")
        return meshes_to_binary([mesh.vertices], [mesh.faces]), snap_time

    def get_requested_geometry(self, req):
        """Shared request dispatch (also used by the websocket handler).
        Ref :259. Returns None or the framed binary message:
        int32[4] (type_id, view_id, snap_time, 0) + geometry bytes."""
        for att in ("type", "category", "id", "time", "view_id"):
            if att not in req:
                logger.error("Request missing key %s: %s", att, req)
                return None
        req_id = int(req["id"])
        req_time = float(req["time"])
        cur = float(req["current_time"]) if "current_time" in req else None

        if req.get("type") == "mesh":
            type_id = 0
            byte_geometry, snap_time = self.parse_encode_mesh(
                req["category"], req_id, req_time, current_time=cur)
        elif req.get("type") == "pointcloud":
            type_id = 1
            byte_geometry, snap_time = self.parse_encode_pointcloud(
                req["category"], req_id, req_time, current_time=cur)
        else:
            logger.error("Unsupported geometry type: %s", req.get("type"))
            return None
        if byte_geometry is None:
            return None
        bininfo = np.array([type_id, int(req["view_id"]), int(snap_time), 0],
                           dtype=np.int32).tobytes()
        return bininfo + byte_geometry


def _make_ws_handler_class():
    from tornado.websocket import WebSocketHandler

    class GeometryWebSocketHandler(WebSocketHandler):
        """Websocket endpoint streaming Timelapse geometry. Ref :220."""

        def initialize(self, helper):
            self.helper = helper

        def open(self):
            logger.debug("Socket opened.")
            self.write_message({"type": "dirinfo",
                                "data": self.helper.get_directory_info()},
                               binary=False)

        def on_message(self, message):
            try:
                msg = json.loads(message)
            except Exception as e:
                logger.error("Failed to decode incoming message: %s", e)
                return
            if msg.get("type") == "geometry":
                for req in msg.get("data") or []:
                    try:
                        byte_message = self.helper.get_requested_geometry(req)
                    except Exception as e:
                        logger.error("Failed geometry request %s: %s", req, e)
                        continue
                    if byte_message is not None:
                        self.write_message(byte_message, binary=True)

        def on_close(self):
            logger.info("Socket closed.")

    return GeometryWebSocketHandler


def __getattr__(name):
    """``GeometryWebSocketHandler``, built at first use: tornado is imported
    then, not when this module is (None where tornado is not installed, as
    in the JAX package)."""
    if name != "GeometryWebSocketHandler":
        raise AttributeError(name)
    try:
        handler = _make_ws_handler_class()
    except ImportError:  # tornado not installed
        handler = None
    globals()[name] = handler
    return handler
