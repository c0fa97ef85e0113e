"""Camera intrinsics: projection from camera space to NDC.

Counterpart of ``kaolin_tpu/render/camera/intrinsics.py``, for the pinhole
and orthographic lenses. Conventions: left-handed NDC (depth increases into
the screen), the camera looks down −z (OpenGL), NDC range [-1, 1].

``params`` is a (num_cameras, P) tensor; width, height, near and far are
Python numbers.
"""

import enum
import math

import torch

__all__ = [
    "CameraFOV",
    "CameraIntrinsics",
    "PinholeIntrinsics",
    "OrthographicIntrinsics",
    "up_to_homogeneous",
    "down_from_homogeneous",
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
    return torch.tensor(values, dtype=dtype, device=device).expand(
        num_cameras, len(values))


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


class PinholeIntrinsics(CameraIntrinsics):
    """Perspective pinhole camera. Params: (x0, y0, focal_x, focal_y)."""

    PARAMS = ("x0", "y0", "focal_x", "focal_y")

    @classmethod
    def from_focal(cls, width, height, focal_x, focal_y=None, x0=0.0,
                   y0=0.0, near=DEFAULT_NEAR, far=DEFAULT_FAR, num_cameras=1,
                   dtype=torch.float32, device="cpu"):
        focal_y = focal_x if focal_y is None else focal_y
        return cls(width, height,
                   _params([x0, y0, focal_x, focal_y], num_cameras, dtype,
                           device), near, far)

    @classmethod
    def from_fov(cls, width, height, fov, fov_direction=CameraFOV.VERTICAL,
                 x0=0.0, y0=0.0, near=DEFAULT_NEAR, far=DEFAULT_FAR,
                 num_cameras=1, dtype=torch.float32, device="cpu"):
        """``fov`` in radians."""
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

    def tan_half_fov(self, camera_fov_direction=CameraFOV.VERTICAL):
        if camera_fov_direction is CameraFOV.HORIZONTAL:
            return (self.width / 2.0) / self.focal_x
        if camera_fov_direction is CameraFOV.VERTICAL:
            return (self.height / 2.0) / self.focal_y
        diag = math.sqrt(self.width ** 2 + self.height ** 2) / 2.0
        return diag / self.focal_x

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
        """(1, 4, 4) frustum → clip matrix, NDC range [-1, 1]."""
        if (self.ndc_min, self.ndc_max) != (-1.0, 1.0):
            raise NotImplementedError(
                f"NDC range [{self.ndc_min}, {self.ndc_max}] unsupported")
        tx = -(right + left) / (right - left)
        ty = -(top + bottom) / (top - bottom)
        u = -2.0 * near * far / (far - near)
        v = -(far + near) / (far - near)
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
                     device="cpu"):
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
