"""Camera intrinsics: projection from camera space to NDC.

Counterpart of ``kaolin_tpu/render/camera/intrinsics.py``, for the pinhole
and orthographic lenses. Conventions: left-handed NDC (depth increases into
the screen), the camera looks down −z (OpenGL), NDC range [-1, 1] by
default.

``params`` is a (num_cameras, P) tensor, the differentiable parameters
(:meth:`CameraIntrinsics.parameters`); width, height, near, far and the NDC
range are Python numbers.
"""

import enum
import math

import torch

from kaolin_tpu_torch.utils.backend import (
    first_tensor,
    input_device,
    resolve_device,
)
from kaolin_tpu_torch.utils.numerics import clip

__all__ = [
    "CameraFOV",
    "CameraIntrinsics",
    "PinholeIntrinsics",
    "OrthographicIntrinsics",
    "up_to_homogeneous",
    "down_from_homogeneous",
    "IntrinsicsParamsDefEnum",
    "PinholeParamsDefEnum",
    "OrthoParamsDefEnum",
    "allclose",
]

DEFAULT_NEAR = 1e-2
DEFAULT_FAR = 1e2


class CameraFOV(enum.Enum):
    """Camera field-of-view direction."""
    HORIZONTAL = 0
    VERTICAL = 1
    DIAGONAL = 2


def up_to_homogeneous(vectors):
    """Append w = 1 if needed."""
    if vectors.shape[-1] == 4:
        return vectors
    return torch.cat([vectors, torch.ones_like(vectors[..., :1])], dim=-1)


def down_from_homogeneous(vectors):
    """Perspective divide by w."""
    return vectors[..., :-1] / vectors[..., -1:]


def _params(values, num_cameras, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device).repeat(
        num_cameras, 1)


class CameraIntrinsics:
    """Base class of batched intrinsics."""

    def __init__(self, width, height, params, near=DEFAULT_NEAR,
                 far=DEFAULT_FAR, ndc_min=-1.0, ndc_max=1.0):
        self.width = int(width)
        self.height = int(height)
        self.params = params
        self.near = float(near)
        self.far = float(far)
        self.ndc_min = float(ndc_min)
        self.ndc_max = float(ndc_max)

    def __len__(self):
        return self.params.shape[0]

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

    def project(self, vectors):
        """Camera space → homogeneous clip space (C, B, 4)."""
        v = up_to_homogeneous(vectors)
        if v.dim() == 2:
            v = v[None]
        return torch.einsum("cij,cbj->cbi", self.projection_matrix(), v)

    def transform(self, vectors):
        """Camera space → NDC with the perspective divide (C, B, 3)."""
        return down_from_homogeneous(self.project(vectors))

    def _new(self, params):
        return type(self)(self.width, self.height, params, self.near,
                          self.far, self.ndc_min, self.ndc_max)

    def normalize_depth(self, depth):
        """Camera depth → NDC depth in [min(ndc), max(ndc)]."""
        if depth.dim() < 2:
            depth = depth.expand((len(self),) + tuple(depth.shape))
        proj = self.projection_matrix()
        a = -proj[:, 2, 2]
        b = -proj[:, 2, 3]
        depth = clip(depth, min(self.near, self.far),
                     max(self.near, self.far))
        ndc_depth = a[:, None] - b[:, None] / depth
        return clip(ndc_depth, min(self.ndc_min, self.ndc_max),
                    max(self.ndc_min, self.ndc_max))

    def __getitem__(self, item):
        return self._new(self.params[item].reshape(-1,
                                                   self.params.shape[-1]))

    def aspect_ratio(self):
        """Width over height."""
        return self.width / self.height

    def clip_mask(self, depth):
        """Bool mask of the ``depth`` values between near and far."""
        lo, hi = min(self.near, self.far), max(self.near, self.far)
        return (depth >= lo) & (depth <= hi)

    def viewport_matrix(self, vl=0, vr=None, vb=0, vt=None, min_depth=0.0,
                        max_depth=1.0):
        """NDC → pixel-space matrix (glViewport), (1, 4, 4): NDC x and y in
        [-1, 1] go to [vl, vr] x [vb, vt], NDC z in [ndc_min, ndc_max] to
        [min_depth, max_depth]."""
        vr = self.width if vr is None else vr
        vt = self.height if vt is None else vt
        vl, vr, vb, vt = float(vl), float(vr), float(vb), float(vt)
        ndc_d = self.ndc_max - self.ndc_min
        vw, vh = vr - vl, vt - vb
        dr = max_depth - min_depth
        m = torch.tensor([
            [vw / 2.0, 0.0, 0.0, vw / 2.0 + vl],
            [0.0, vh / 2.0, 0.0, vh / 2.0 + vb],
            [0.0, 0.0, dr / ndc_d, -(self.ndc_min / ndc_d) * dr + min_depth],
            [0.0, 0.0, 0.0, 1.0]], dtype=self.dtype, device=self.device)
        return m[None]

    def set_ndc_range(self, ndc_min, ndc_max):
        """Unsupported, as in the JAX package and the reference."""
        raise NotImplementedError(
            "Currently only NDC space of [-1, 1] is supported.")

    @classmethod
    def cat(cls, intrinsics):
        """Concatenate same-type, same-canvas intrinsics along the batch
        dim."""
        first = intrinsics[0]
        for other in intrinsics[1:]:
            if type(other) is not type(first) or \
                    (other.width, other.height) != (first.width,
                                                    first.height):
                raise ValueError(
                    "cat needs same-type, same-canvas intrinsics")
        return first._new(torch.cat([i.params for i in intrinsics], dim=0))

    # -- the differentiable parameters --
    PARAMS = ()   # a subclass's parameter names, in params order

    def parameters(self):
        """The parameter tensor (C, P)."""
        return self.params

    @classmethod
    def param_types(cls):
        """Names of the per-camera parameters, in params order."""
        return cls.PARAMS

    def param_count(self):
        """Number of parameters a camera."""
        return len(self.param_types())

    def named_params(self):
        """Per camera, {name: value}."""
        p = self.params.detach().cpu().tolist()
        return [dict(zip(self.param_types(), row)) for row in p]

    def gradient_mask(self, *args):
        """Bool mask over :meth:`parameters` selecting the named params
        (names or :class:`IntrinsicsParamsDefEnum` members)."""
        names = self.param_types()
        mask = torch.zeros(self.params.shape, dtype=torch.bool,
                           device=self.device)
        for a in args:
            name = a if isinstance(a, str) else a.name
            if name not in names:
                raise ValueError(
                    f"unknown intrinsics param {name!r}; valid: {names}")
            mask[:, names.index(name)] = True
        return mask

    def as_dict(self):
        """JSON-writable constructor dict; :meth:`from_dict` reads it."""
        return {"classname": type(self).__name__,
                "width": self.width, "height": self.height,
                "near": self.near, "far": self.far,
                "ndc_min": self.ndc_min, "ndc_max": self.ndc_max,
                "params": self.params.detach().cpu().tolist()}

    @staticmethod
    def from_dict(in_dict, dtype=torch.float32, device=None):
        """The subclass that :meth:`as_dict` names, rebuilt on ``device``
        (the CUDA device unless one is given)."""
        registry = {c.__name__: c for c in CameraIntrinsics.__subclasses__()}
        name = in_dict.get("classname")
        if name not in registry:
            raise ValueError(f"classname {name!r} not a registered "
                             f"CameraIntrinsics subclass: {sorted(registry)}")
        device = resolve_device(device, "CameraIntrinsics.from_dict")
        return registry[name](
            in_dict["width"], in_dict["height"],
            torch.tensor(in_dict["params"], dtype=dtype, device=device),
            in_dict.get("near", DEFAULT_NEAR), in_dict.get("far", DEFAULT_FAR),
            in_dict.get("ndc_min", -1.0), in_dict.get("ndc_max", 1.0))


class PinholeIntrinsics(CameraIntrinsics):
    """Perspective pinhole camera. Params: (x0, y0, focal_x, focal_y)."""

    PARAMS = ("x0", "y0", "focal_x", "focal_y")

    @classmethod
    def from_focal(cls, width, height, focal_x, focal_y=None, x0=0.0,
                   y0=0.0, near=DEFAULT_NEAR, far=DEFAULT_FAR, num_cameras=1,
                   dtype=torch.float32, device=None):
        """Params on ``device``, else where the first tensor among the focal
        lengths and the principal point lies, else on the CUDA device."""
        device = input_device(first_tensor(focal_x, focal_y, x0, y0), device,
                              "PinholeIntrinsics.from_focal")
        focal_y = focal_x if focal_y is None else focal_y
        return cls(width, height,
                   _params([x0, y0, focal_x, focal_y], num_cameras, dtype,
                           device), near, far)

    @classmethod
    def from_fov(cls, width, height, fov, fov_direction=CameraFOV.VERTICAL,
                 x0=0.0, y0=0.0, near=DEFAULT_NEAR, far=DEFAULT_FAR,
                 num_cameras=1, dtype=torch.float32, device=None):
        """``fov`` in radians; params on ``device``, else on the CUDA
        device."""
        device = resolve_device(device, "PinholeIntrinsics.from_fov")
        tan_half = math.tan(fov / 2.0)
        half = width / 2.0 if fov_direction is CameraFOV.HORIZONTAL \
            else height / 2.0
        focal = half / tan_half
        return cls.from_focal(width, height, focal, focal, x0, y0, near, far,
                              num_cameras, dtype, device)

    @property
    def lens_type(self):
        return "pinhole"

    x0 = property(lambda self: self.params[:, 0])
    y0 = property(lambda self: self.params[:, 1])
    focal_x = property(lambda self: self.params[:, 2])
    focal_y = property(lambda self: self.params[:, 3])

    @property
    def cx(self):
        """Principal point x in image coords."""
        return self.params[:, 0] + self.width / 2

    @property
    def cy(self):
        """Principal point y in image coords."""
        return self.params[:, 1] + self.height / 2

    def tan_half_fov(self, camera_fov_direction=CameraFOV.VERTICAL):
        if camera_fov_direction is CameraFOV.HORIZONTAL:
            return (self.width / 2.0) / self.focal_x
        if camera_fov_direction is CameraFOV.VERTICAL:
            return (self.height / 2.0) / self.focal_y
        diag = math.sqrt(self.width ** 2 + self.height ** 2) / 2.0
        return diag / self.focal_x

    def fov(self, camera_fov_direction=CameraFOV.VERTICAL, in_degrees=True):
        """The field of view (C,), in degrees unless ``in_degrees`` is
        False."""
        f = 2.0 * torch.arctan(self.tan_half_fov(camera_fov_direction))
        return torch.rad2deg(f) if in_degrees else f

    def zoom(self, amount):
        """Narrow the vertical field of view by ``amount`` degrees, keeping
        the ratio of the two fields of view → new intrinsics."""
        fov_y = torch.deg2rad(self.fov(CameraFOV.VERTICAL))
        fov_x = torch.deg2rad(self.fov(CameraFOV.HORIZONTAL))
        new_fov_y = fov_y - torch.deg2rad(torch.as_tensor(
            amount, dtype=self.dtype, device=self.device))
        new_fov_x = new_fov_y * fov_x / fov_y
        focal_y = (self.height / 2) / torch.tan(new_fov_y / 2.0)
        focal_x = (self.width / 2) / torch.tan(new_fov_x / 2.0)
        return self._new(torch.stack([self.params[:, 0], self.params[:, 1],
                                      focal_x, focal_y], dim=-1))

    def perspective_matrix(self):
        """(C, 4, 4) intrinsic matrix in homogeneous form."""
        zero = torch.zeros_like(self.focal_x)
        one = torch.ones_like(self.focal_x)
        rows = [
            torch.stack([self.focal_x, zero, -self.x0, zero], dim=-1),
            torch.stack([zero, self.focal_y, -self.y0, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
        ]
        return torch.stack(rows, dim=1)

    def ndc_matrix(self, left, right, bottom, top, near, far):
        """(1, 4, 4) frustum → clip matrix, for the NDC depth ranges [-1, 1],
        [0, 1] and [1, 0]."""
        tx = -(right + left) / (right - left)
        ty = -(top + bottom) / (top - bottom)
        ndc = (self.ndc_min, self.ndc_max)
        if ndc == (-1.0, 1.0):
            u = -2.0 * near * far / (far - near)
            v = -(far + near) / (far - near)
        elif ndc == (0.0, 1.0):
            u = (near * far) / (near - far)
            v = far / (far - near)
        elif ndc == (1.0, 0.0):
            u = (near * far) / (far - near)
            v = near / (far - near)
        else:
            raise NotImplementedError(
                f"NDC range [{self.ndc_min}, {self.ndc_max}] unsupported")
        m = torch.tensor([
            [2.0 / (right - left), 0.0, 0.0, -tx],
            [0.0, 2.0 / (top - bottom), 0.0, -ty],
            [0.0, 0.0, u, v],
            [0.0, 0.0, 0.0, -1.0],
        ], dtype=self.dtype, device=self.device)
        return m[None]

    def projection_matrix(self):
        """OpenGL-compatible projection (C, 4, 4)."""
        top = self.height / 2
        right = self.width / 2
        ndc = self.ndc_matrix(-right, right, -top, top, self.near, self.far)
        return ndc @ self.perspective_matrix()


class OrthographicIntrinsics(CameraIntrinsics):
    """Orthographic camera. Params: (fov_distance,)."""

    PARAMS = ("fov_distance",)

    @classmethod
    def from_frustum(cls, width, height, fov_distance=1.0, near=DEFAULT_NEAR,
                     far=DEFAULT_FAR, num_cameras=1, dtype=torch.float32,
                     device=None):
        """Params on ``device``, else where ``fov_distance`` lies when it
        is a tensor, else on the CUDA device."""
        device = input_device(fov_distance, device,
                              "OrthographicIntrinsics.from_frustum")
        return cls(width, height,
                   _params([fov_distance], num_cameras, dtype, device), near,
                   far)

    @property
    def lens_type(self):
        return "ortho"

    fov_distance = property(lambda self: self.params[:, 0])

    def orthographic_matrix(self, left, right, bottom, top, near, far):
        """(C, 4, 4)."""
        fov = self.fov_distance
        zero = torch.zeros_like(fov)
        one = torch.ones_like(fov)
        tx = torch.full_like(fov, -(right + left) / (right - left))
        ty = torch.full_like(fov, -(top + bottom) / (top - bottom))
        tz = torch.full_like(fov, -(far + near) / (far - near))
        d = torch.full_like(fov, far - near)
        rows = [
            torch.stack([2.0 / (fov * (right - left)), zero, zero, tx],
                        dim=-1),
            torch.stack([zero, 2.0 / (fov * (top - bottom)), zero, ty],
                        dim=-1),
            torch.stack([zero, zero, -2.0 / d, tz], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ]
        return torch.stack(rows, dim=1)

    def projection_matrix(self):
        """A unit-height frustum scaled by the aspect ratio."""
        right = 1.0 * self.width / self.height
        return self.orthographic_matrix(-right, right, -1.0, 1.0, self.near,
                                        self.far)

    def zoom(self, amount):
        """Add ``amount`` to the distance of view, kept ≥ 1e-5."""
        return self._new(clip(self.params + amount, 1e-5, None))


class IntrinsicsParamsDefEnum(enum.IntEnum):
    """Base of the enums naming the slots of an intrinsics params
    vector."""


class PinholeParamsDefEnum(IntrinsicsParamsDefEnum):
    """The pinhole params layout (no axis skew)."""
    x0 = 0
    y0 = 1
    focal_x = 2
    focal_y = 3


class OrthoParamsDefEnum(IntrinsicsParamsDefEnum):
    """The orthographic params layout: one zoom scale, in distance
    units."""
    fov_distance = 0


def allclose(input, other, rtol=1e-05, atol=1e-08, equal_nan=False):
    """Two intrinsics of one lens type and canvas with close near, far and
    params."""
    return (type(input) is type(other)
            and input.width == other.width and input.height == other.height
            and math.isclose(input.near, other.near, rel_tol=rtol,
                             abs_tol=atol)
            and math.isclose(input.far, other.far, rel_tol=rtol,
                             abs_tol=atol)
            and input.params.shape == other.params.shape
            and bool(torch.allclose(input.params.detach().cpu(),
                                    other.params.detach().cpu(), rtol=rtol,
                                    atol=atol, equal_nan=equal_nan)))
