"""The Camera class: extrinsics × intrinsics.

Counterpart of ``kaolin_tpu/render/camera/camera.py``. A camera's
differentiable parameters are its extrinsics' and intrinsics' params
tensors (:meth:`Camera.parameters`).
"""

import torch

from kaolin_tpu_torch.render.camera import extrinsics as _ext
from kaolin_tpu_torch.render.camera import intrinsics as _int
from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics
from kaolin_tpu_torch.render.camera.intrinsics import (
    CameraFOV,
    CameraIntrinsics,
    OrthographicIntrinsics,
    PinholeIntrinsics,
)
from kaolin_tpu_torch.render.camera.raygen import generate_rays
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["Camera", "allclose"]

class Camera:
    """Batched camera. Construct with :meth:`from_args`."""

    def __init__(self, extrinsics, intrinsics):
        if len(extrinsics) != len(intrinsics):
            raise ValueError("extrinsics and intrinsics batch sizes differ")
        self.extrinsics = extrinsics
        self.intrinsics = intrinsics

    @classmethod
    def from_args(cls, **kwargs):
        """Build a camera from a valid combination of arguments::

            Camera.from_args(eye=..., at=..., up=..., fov=..., width=...,
                             height=...)
            Camera.from_args(view_matrix=..., focal_x=..., width=...,
                             height=...)
            Camera.from_args(eye=..., at=..., up=..., fov_distance=1.0,
                             width=..., height=...)

        ``device`` places the parameters; where it is not given, the
        extrinsics go where their first tensor argument lies, else on the
        CUDA device (raising without one), and the intrinsics follow them.
        ``dtype`` defaults to float32.
        """
        dtype = kwargs.pop("dtype", torch.float32)
        device = kwargs.pop("device", None)
        backend = kwargs.pop("backend", "matrix_se3")
        if "extrinsics" in kwargs:
            extrinsics = kwargs.pop("extrinsics")
        elif all(k in kwargs for k in ("eye", "at", "up")):
            extrinsics = CameraExtrinsics.from_lookat(
                kwargs.pop("eye"), kwargs.pop("at"), kwargs.pop("up"),
                dtype=dtype, device=device, backend=backend)
        elif "view_matrix" in kwargs:
            extrinsics = CameraExtrinsics.from_view_matrix(
                kwargs.pop("view_matrix"), dtype=dtype, device=device,
                backend=backend)
        elif all(k in kwargs for k in ("cam_pos", "cam_dir")):
            extrinsics = CameraExtrinsics.from_camera_pose(
                kwargs.pop("cam_pos"), kwargs.pop("cam_dir"), dtype=dtype,
                device=device, backend=backend)
        else:
            raise ValueError("no valid extrinsics args given")
        if device is None:
            device = extrinsics.device

        if "intrinsics" in kwargs:
            intrinsics = kwargs.pop("intrinsics")
        else:
            width = kwargs.pop("width")
            height = kwargs.pop("height")
            common = {k: kwargs.pop(k) for k in ("near", "far") if k in kwargs}
            common.update(num_cameras=len(extrinsics), dtype=dtype,
                          device=device)
            if "fov" in kwargs:
                intrinsics = PinholeIntrinsics.from_fov(
                    width, height, kwargs.pop("fov"),
                    kwargs.pop("fov_direction", CameraFOV.VERTICAL),
                    kwargs.pop("x0", 0.0), kwargs.pop("y0", 0.0), **common)
            elif "focal_x" in kwargs:
                intrinsics = PinholeIntrinsics.from_focal(
                    width, height, kwargs.pop("focal_x"),
                    kwargs.pop("focal_y", None), kwargs.pop("x0", 0.0),
                    kwargs.pop("y0", 0.0), **common)
            elif "fov_distance" in kwargs:
                intrinsics = OrthographicIntrinsics.from_frustum(
                    width, height, kwargs.pop("fov_distance"), **common)
            else:
                raise ValueError("no valid intrinsics args given")
        if kwargs:
            raise TypeError(
                f"unused Camera.from_args arguments: {sorted(kwargs)}")
        return cls(extrinsics, intrinsics)

    def __len__(self):
        return len(self.extrinsics)

    @property
    def width(self):
        return self.intrinsics.width

    @property
    def height(self):
        return self.intrinsics.height

    @property
    def lens_type(self):
        return self.intrinsics.lens_type

    @property
    def dtype(self):
        return self.extrinsics.dtype

    def __getattr__(self, item):
        # proxy to the intrinsics, then the extrinsics
        intr = object.__getattribute__(self, "intrinsics")
        if hasattr(type(intr), item):
            return getattr(intr, item)
        extr = object.__getattribute__(self, "extrinsics")
        if hasattr(type(extr), item):
            return getattr(extr, item)
        raise AttributeError(item)

    def transform(self, vectors):
        """World space → NDC."""
        return self.intrinsics.transform(self.extrinsics.transform(vectors))

    def __getitem__(self, item):
        return Camera(self.extrinsics[item], self.intrinsics[item])

    def view_projection_matrix(self):
        """(C, 4, 4) world → clip matrix."""
        return self.intrinsics.projection_matrix() \
            @ self.extrinsics.view_matrix()

    def generate_rays(self, coords_grid=None):
        """Ray origins and directions for every pixel."""
        return generate_rays(self, coords_grid)

    # -- the differentiable parameters --
    def parameters(self):
        """(extrinsics params, intrinsics params)."""
        return self.extrinsics.parameters(), self.intrinsics.parameters()

    def gradient_mask(self, *args):
        """(extrinsics mask, intrinsics mask): bool masks selecting the
        named params; ``'R'`` and ``'t'`` go to the extrinsics, any other
        name (e.g. ``'focal_x'``) to the intrinsics."""
        ext_args, int_args = [], []
        for a in args:
            name = a if isinstance(a, str) else a.name
            (ext_args if name in ("R", "t") else int_args).append(name)
        return (self.extrinsics.gradient_mask(*ext_args),
                self.intrinsics.gradient_mask(*int_args))

    def named_params(self):
        """Per camera, the extrinsics' and intrinsics' named params."""
        return [dict(e, **i) for e, i in zip(self.extrinsics.named_params(),
                                             self.intrinsics.named_params())]

    def to_dict(self):
        """JSON-writable dict; :meth:`from_dict` reads it."""
        return {"classname": "Camera",
                "extrinsics": self.extrinsics.to_dict(),
                "intrinsics": self.intrinsics.as_dict()}

    @classmethod
    def from_dict(cls, d, dtype=torch.float32, device=None):
        """The camera :meth:`to_dict` wrote, on ``device`` (the CUDA device
        unless one is given)."""
        if d.get("classname") != "Camera":
            raise ValueError(f"not a Camera dict: {d.get('classname')}")
        device = resolve_device(device, "Camera.from_dict")
        return cls(CameraExtrinsics.from_dict(d["extrinsics"], dtype=dtype,
                                              device=device),
                   CameraIntrinsics.from_dict(d["intrinsics"], dtype=dtype,
                                              device=device))

    @classmethod
    def cat(cls, cameras):
        """Concatenate same-type cameras along the batch dim."""
        return cls(CameraExtrinsics.cat([c.extrinsics for c in cameras]),
                   type(cameras[0].intrinsics).cat(
                       [c.intrinsics for c in cameras]))

    def __repr__(self):
        return (f"Camera(num_cameras={len(self)}, lens={self.lens_type!r}, "
                f"res={self.width}x{self.height})")


def allclose(input, other, rtol=1e-05, atol=1e-08, equal_nan=False):
    """Two cameras whose extrinsics and intrinsics are both close."""
    return (_ext.allclose(input.extrinsics, other.extrinsics, rtol=rtol,
                          atol=atol, equal_nan=equal_nan)
            and _int.allclose(input.intrinsics, other.intrinsics, rtol=rtol,
                              atol=atol, equal_nan=equal_nan))
