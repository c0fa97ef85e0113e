"""Synthetic RGBD view loader (Omniverse Kaolin data-generator format).

Counterpart of ``kaolin_tpu/io/render.py``: per-view
``{idx}_{category}.png/.npy`` files and ``{idx}_metadata.json`` with the
camera's properties.
"""

import json
import math
import os

import numpy as np
import torch

from kaolin_tpu_torch.io.utils import _open_image
from kaolin_tpu_torch.render.camera.legacy import (  # noqa: F401
    generate_perspective_projection,
)
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["import_synthetic_view"]


def import_synthetic_view(root_dir, idx, rgb=True, depth_linear=False,
                          semantic=False, instance=False, normals=False,
                          bbox_2d_tight=False, bbox_2d_loose=False,
                          device=None):
    """Load one synthetic sensor view → dict of tensors on ``device`` (the
    CUDA device unless named) and its metadata: the camera transform (4,
    3), the asset transform, the perspective projection of the camera's
    field of view and aspect ratio, and its clipping range."""
    device = resolve_device(device, "import_synthetic_view")
    output = {}

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    def _import_npy(cat):
        path = os.path.join(root_dir, f"{idx}_{cat}.npy")
        output[cat] = t(np.load(path)) if os.path.exists(path) else None

    def _import_png(cat):
        path = os.path.join(root_dir, f"{idx}_{cat}.png")
        output[cat] = t(np.array(_open_image(path))[:, :, :3].astype(
            np.float32) / 255.0) if os.path.exists(path) else None

    if rgb:
        _import_png("rgb")
    if depth_linear:
        _import_npy("depth_linear")
    if semantic:
        _import_npy("semantic")
    if instance:
        _import_npy("instance")
    if normals:
        _import_png("normals")

    with open(os.path.join(root_dir, f"{idx}_metadata.json")) as f:
        meta = json.load(f)
    cam_props = meta["camera_properties"]
    asset_transforms = t(np.asarray(meta["asset_transforms"][0][1],
                                    np.float32))
    cam_transform = t(np.asarray(cam_props["tf_mat"], np.float32))
    aspect_ratio = (cam_props["resolution"]["width"]
                    / cam_props["resolution"]["height"])
    fov = 2 * math.atan(cam_props["horizontal_aperture"]
                        / (2 * cam_props["focal_length"]))
    output["metadata"] = {
        "cam_transform": cam_transform[:, :3],
        "asset_transforms": asset_transforms,
        "cam_proj": generate_perspective_projection(fov, aspect_ratio,
                                                    device=device),
        "clipping_range": cam_props["clipping_range"],
    }
    if bbox_2d_tight:
        output["bbox_2d_tight"] = meta["bbox_2d_tight"]
    if bbox_2d_loose:
        output["bbox_2d_loose"] = meta["bbox_2d_loose"]
    return output
