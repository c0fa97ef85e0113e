"""Timelapse — USD-based 3D training checkpoints.

Counterpart of ``kaolin_tpu/visualize/timelapse.py`` (reference
``kaolin/visualize/timelapse.py``, Timelapse :47-229, TimelapseParser :230):
writes per-iteration meshes / pointclouds / voxelgrids as time-sampled USDA
files under a log directory, and parses them back. Backed by the
self-contained USDA module (:mod:`kaolin_tpu_torch.io.usd`). Tensors on any
device are accepted and written from the host; the files equal the JAX
package's byte for byte.

An open (per-sample USDA stage) is kept in memory and re-saved on every add —
appending new timeSamples like the reference's Usd.Stage.Open flow.
"""

import json
import os
import posixpath
import re


from kaolin_tpu_torch.io import usd as usd_io
from kaolin_tpu_torch.io.utils import _host

__all__ = ["Timelapse", "TimelapseParser"]


class Timelapse:
    """3D checkpoint writer. Ref :24."""

    def __init__(self, log_dir, up_axis="Y"):
        self.logdir = log_dir
        self.up_axis = up_axis
        os.makedirs(log_dir, exist_ok=True)
        self._stages = {}

    def _get_stage(self, path):
        if path not in self._stages:
            self._stages[path] = usd_io.create_stage(path, self.up_axis)
        return self._stages[path]

    @staticmethod
    def _to_list(value):
        if value is None:
            return None
        if isinstance(value, (list, tuple)):
            return list(value)
        arr = _host(value)
        if arr.ndim == 3:
            return [arr[i] for i in range(arr.shape[0])]
        return [arr]

    def add_pointcloud_batch(self, iteration=0, category="",
                             pointcloud_list=None, colors=None,
                             points_type="point_instancer"):
        """Write a batch of pointclouds at this iteration. Ref :47."""
        pointcloud_list = self._to_list(pointcloud_list)
        colors = self._to_list(colors) or [None] * len(pointcloud_list)
        pc_dir = posixpath.join(self.logdir, category)
        os.makedirs(pc_dir, exist_ok=True)
        for i, (points, colour) in enumerate(zip(pointcloud_list, colors)):
            path = posixpath.join(pc_dir, f"pointcloud_{i}.usda")
            stage = self._get_stage(path)
            stage.add_pointcloud(f"/pointcloud_{i}", _host(points),
                                 time=iteration,
                                 colors=None if colour is None
                                 else _host(colour))
            stage.save()

    def add_mesh_batch(self, iteration=0, category="", vertices_list=None,
                       faces_list=None, uvs_list=None, face_uvs_idx_list=None,
                       face_normals_list=None, materials_list=None):
        """Write a batch of meshes at this iteration. Ref :148."""
        vertices_list = self._to_list(vertices_list)
        faces_list = self._to_list(faces_list)
        n = max(len(x) for x in (vertices_list, faces_list) if x is not None)
        mesh_dir = posixpath.join(self.logdir, category)
        os.makedirs(mesh_dir, exist_ok=True)
        for i in range(n):
            path = posixpath.join(mesh_dir, f"mesh_{i}.usda")
            stage = self._get_stage(path)
            stage.add_mesh(
                f"/mesh_{i}",
                None if vertices_list is None else _host(vertices_list[i]),
                None if faces_list is None else _host(faces_list[i]),
                time=iteration)
            stage.save()

    def add_voxelgrid_batch(self, iteration=0, category="",
                            voxelgrid_list=None, colors=None,
                            semantic_ids=None):
        """Write a batch of voxelgrids at this iteration. Ref :101."""
        voxelgrid_list = self._to_list(voxelgrid_list)
        vg_dir = posixpath.join(self.logdir, category)
        os.makedirs(vg_dir, exist_ok=True)
        for i, vg in enumerate(voxelgrid_list):
            path = posixpath.join(vg_dir, f"voxelgrid_{i}.usda")
            stage = self._get_stage(path)
            stage.add_voxelgrid(f"/voxelgrid_{i}", _host(vg),
                                time=iteration)
            stage.save()


class TimelapseParser:
    """Parses a Timelapse log directory. Ref :230."""

    TYPES = ("mesh", "pointcloud", "voxelgrid")

    def __init__(self, log_dir):
        self.logdir = log_dir
        self.dir_info = {t: {} for t in self.TYPES}
        self.check_for_updates()

    def check_for_updates(self):
        """Rescan the directory; returns True if anything changed. Ref :305."""
        new_info = {t: {} for t in self.TYPES}
        for root, _, files in os.walk(self.logdir):
            for fn in files:
                m = re.match(r"(mesh|pointcloud|voxelgrid)_(\d+)\.usda?$", fn)
                if not m:
                    continue
                typ, idx = m.group(1), int(m.group(2))
                category = os.path.relpath(root, self.logdir)
                category = "" if category == "." else category
                path = os.path.join(root, fn)
                times = self._get_timestamps(path)
                new_info[typ].setdefault(category, {})[idx] = {
                    "path": path, "times": times,
                    "end_time": max(times) if times else 0}
        changed = new_info != self.dir_info
        self.dir_info = new_info
        return changed

    @staticmethod
    def _get_timestamps(path):
        with open(path, "rb") as f:
            src = f.read()
        from kaolin_tpu_torch.io.usd.crate import CrateFile, is_crate
        if is_crate(src[:8]):
            # binary checkpoint (stock USD writers default to crate):
            # union of authored timeSample keys across all attributes
            crate = CrateFile(path)
            times = set()
            for _, _, fields in crate.specs:
                rep = fields.get("timeSamples")
                if rep is not None:
                    samples = crate.value(rep)
                    if samples:
                        times.update(samples)
            return sorted(times)
        return sorted({float(m.group(1))
                       for m in re.finditer(r"^\s*([\d.]+)\s*:",
                                            src.decode("utf-8", "replace"),
                                            re.MULTILINE)})

    def get_file_path(self, type, category, id):
        """Ref :290."""
        return self.dir_info[type][category][id]["path"]

    def get_category_names_by_type(self, type):
        """Category names logged for ``type`` (None for unknown types).
        Ref :346."""
        if type not in self.dir_info:
            return None
        return sorted(self.dir_info[type])

    def get_category_info(self, type, category):
        """Serializable summary for one (type, category): ids, per-id file
        paths and the latest authored time. Ref :350."""
        if type not in self.dir_info or category not in self.dir_info[type]:
            return None
        items = self.dir_info[type][category]
        return {"category": category,
                "ids": sorted(items),
                "paths": [items[i]["path"] for i in sorted(items)],
                "end_time": max((v["end_time"] for v in items.values()),
                                default=0)}

    @staticmethod
    def get_filepaths(logdir):
        """All Timelapse-convention USD files under ``logdir``, keyed by
        (typestr, category, id). Ref :356."""
        out = {}
        for root, _, files in os.walk(logdir):
            for fn in files:
                m = re.match(r"(mesh|pointcloud|voxelgrid)_(\d+)\.usda?$", fn)
                if not m:
                    continue
                category = os.path.relpath(root, logdir)
                category = "" if category == "." else category
                out[(m.group(1), category, int(m.group(2)))] = \
                    os.path.join(root, fn)
        return out

    @staticmethod
    def parse_filepath_info(filepaths):
        """Summarize :meth:`get_filepaths` output per type → list of
        category-info dicts. Ref :390."""
        info = {}
        for (typ, cat, idx), path in sorted(filepaths.items()):
            times = TimelapseParser._get_timestamps(path)
            cats = info.setdefault(typ, {})
            entry = cats.setdefault(cat, {"category": cat, "ids": [],
                                          "end_time": 0})
            entry["ids"].append(idx)
            entry["end_time"] = max(entry["end_time"],
                                    max(times) if times else 0)
        return {typ: list(cats.values()) for typ, cats in info.items()}

    def _count(self, typ):
        return sum(len(v) for v in self.dir_info[typ].values())

    def num_mesh_items(self):
        return self._count("mesh")

    def num_pointcloud_items(self):
        return self._count("pointcloud")

    def num_voxelgrid_items(self):
        return self._count("voxelgrid")

    def num_mesh_categories(self):
        return len(self.dir_info["mesh"])

    def num_pointcloud_categories(self):
        return len(self.dir_info["pointcloud"])

    def num_voxelgrid_categories(self):
        return len(self.dir_info["voxelgrid"])

    def get_category_ids(self, typ):
        return sorted(self.dir_info[typ].keys())

    def serializable(self):
        return json.dumps({t: {c: sorted(ids.keys()) for c, ids in v.items()}
                           for t, v in self.dir_info.items()})
