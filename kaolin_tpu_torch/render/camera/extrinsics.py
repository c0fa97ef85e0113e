"""Camera extrinsics: the world → camera rigid transform.

Counterpart of ``kaolin_tpu/render/camera/extrinsics.py``. ``params`` is a
(C, P) tensor read by ``backend``:

* ``matrix_se3``: (C, 12), the flattened rotation rows, then the
  translation;
* ``matrix_6dof_rotation``: (C, 9), two rotation rows (Gram-Schmidt
  orthonormalized when read, the third their cross product), then the
  translation;
* any name registered with
  :func:`~kaolin_tpu_torch.render.camera.extrinsics_backends.register_backend`.

Every method that changes the camera returns a new object, as in the JAX
package. :meth:`CameraExtrinsics.parameters` is the params tensor itself:
make it require grad, and gradients of anything computed from the camera
reach it.
"""

import numpy as np
import torch

from kaolin_tpu_torch.render.camera.extrinsics_backends import (
    _BACKEND_REGISTRY,
    ExtrinsicsParamsDefEnum,
    get_backend,
)
from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["CameraExtrinsics", "allclose"]

_BUILTIN = ("matrix_se3", "matrix_6dof_rotation")


def _to_batched_3(x, dtype, device):
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.dim() <= 2 and x.numel() % 3 == 0:
        x = x.reshape(-1, 3)
    return x[None] if x.dim() == 1 else x


def _eye4(c, dtype, device):
    return torch.eye(4, dtype=dtype, device=device).repeat(c, 1, 1)


def _registered(name):
    rep = get_backend(name)
    if rep is None:
        raise ValueError(f"unknown extrinsics backend {name!r}")
    return rep


class CameraExtrinsics:
    """Batched world → camera transform: x_cam = R x_world + t."""

    def __init__(self, params, backend="matrix_se3", base_change=None):
        self.params = params
        self.backend = backend
        # the accumulated change of coordinate system, a tuple of rows;
        # None is the identity
        self._base_change = base_change

    # -- constructors --
    @classmethod
    def _from_R_t(cls, R, t, backend="matrix_se3"):
        if backend == "matrix_se3":
            params = torch.cat([R.reshape(-1, 9), t.reshape(-1, 3)], dim=-1)
        elif backend == "matrix_6dof_rotation":
            params = torch.cat([R[:, 0, :], R[:, 1, :], t.reshape(-1, 3)],
                               dim=-1)
        else:
            params = _registered(backend).params_from_Rt(R, t.reshape(-1, 3))
        return cls(params, backend=backend)

    @classmethod
    def from_lookat(cls, eye, at, up, dtype=torch.float32, device="cpu",
                    backend="matrix_se3"):
        """glm-compatible right-handed look-at, in the JAX package's op
        order."""
        eye = _to_batched_3(eye, dtype, device)
        at = _to_batched_3(at, dtype, device)
        up = _to_batched_3(up, dtype, device)
        backward = at - eye
        backward = backward / torch.linalg.vector_norm(backward, dim=-1,
                                                       keepdim=True)
        right = torch.linalg.cross(backward, up.expand_as(backward))
        right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
        up = torch.linalg.cross(right, backward)
        R = torch.stack([right, up, -backward], dim=1)       # (C, 3, 3)
        t = -torch.einsum("cij,cj->ci", R, eye)
        return cls._from_R_t(R, t, backend)

    @classmethod
    def from_camera_pose(cls, cam_pos, cam_dir, dtype=torch.float32,
                         device="cpu", backend="matrix_se3"):
        """From the camera's world position (C, 3) and its orientation
        (C, 3, 3), the camera axes as columns in world space."""
        cam_pos = _to_batched_3(cam_pos, dtype, device)
        cam_dir = torch.as_tensor(cam_dir, dtype=dtype, device=device)
        if cam_dir.dim() == 2:
            cam_dir = cam_dir[None]
        R = cam_dir.transpose(-1, -2)
        t = -torch.einsum("cij,cj->ci", R, cam_pos)
        return cls._from_R_t(R, t, backend)

    @classmethod
    def from_view_matrix(cls, view_matrix, dtype=torch.float32, device="cpu",
                         backend="matrix_se3"):
        """From a (C, 4, 4) world → camera matrix."""
        m = torch.as_tensor(view_matrix, dtype=dtype, device=device)
        if m.dim() == 2:
            m = m[None]
        return cls._from_R_t(m[:, :3, :3], m[:, :3, 3], backend)

    # -- materialization --
    @property
    def R(self):
        """(C, 3, 3) rotation."""
        if self.backend == "matrix_se3":
            return self.params[:, :9].reshape(-1, 3, 3)
        if self.backend != "matrix_6dof_rotation":
            return _registered(self.backend).R(self.params)
        a1 = self.params[:, 0:3]
        a2 = self.params[:, 3:6]
        norm = torch.linalg.vector_norm
        b1 = a1 / clip(norm(a1, dim=-1, keepdim=True), 1e-12, None)
        a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
        b2 = a2p / clip(norm(a2p, dim=-1, keepdim=True), 1e-12, None)
        b3 = torch.linalg.cross(b1, b2)
        return torch.stack([b1, b2, b3], dim=1)

    @property
    def t(self):
        """(C, 3, 1) translation."""
        if self.backend not in _BUILTIN:
            return _registered(self.backend).t(self.params)
        return self.params[:, -3:, None]

    def __len__(self):
        return self.params.shape[0]

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

    # -- API --
    def switch_backend(self, backend_name):
        """The same transform in another parameterization (gradients then
        flow through the new params)."""
        return CameraExtrinsics._from_R_t(self.R, self.t[..., 0],
                                          backend_name)

    def view_matrix(self):
        """(C, 4, 4) world → camera matrix."""
        m = _eye4(len(self), self.dtype, self.device)
        m[:, :3, :3] = self.R
        m[:, :3, 3] = self.t[..., 0]
        return m

    def inv_view_matrix(self):
        """(C, 4, 4) camera → world matrix."""
        Rt = self.R.transpose(-1, -2)
        m = _eye4(len(self), self.dtype, self.device)
        m[:, :3, :3] = Rt
        m[:, :3, 3] = -torch.einsum("cij,cj->ci", Rt, self.t[..., 0])
        return m

    def update(self, mat):
        """A new extrinsics with the view matrix ``mat``."""
        return CameraExtrinsics.from_view_matrix(
            mat, dtype=self.dtype, device=self.device, backend=self.backend)

    def transform(self, vectors):
        """World → camera coords: (B, 3) or (C, B, 3) → (C, B, 3)."""
        if vectors.dim() == 2:
            vectors = vectors[None]
        return torch.einsum("cij,cbj->cbi", self.R, vectors) \
            + self.t[:, None, :, 0]

    def inv_transform_rays(self, ray_orig, ray_dir):
        """Camera → world for ray bundles (B, 3) or (C, B, 3)."""
        if ray_orig.dim() == 2:
            ray_orig = ray_orig[None]
        if ray_dir.dim() == 2:
            ray_dir = ray_dir[None]
        Rt = self.R.transpose(-1, -2)
        d = torch.einsum("cij,cbj->cbi", Rt, ray_dir)
        o = torch.einsum("cij,cbj->cbi", Rt, ray_orig - self.t[:, None, :, 0])
        return o, d

    def cam_pos(self):
        """Camera centre in world coords (C, 3, 1)."""
        Rt = self.R.transpose(-1, -2)
        return -torch.einsum("cij,cj->ci", Rt, self.t[..., 0])[..., None]

    def cam_right(self):
        return self.R[:, 0, :, None]

    def cam_up(self):
        return self.R[:, 1, :, None]

    def cam_forward(self):
        """The camera's z axis in world coords, Rᵀ e_z: from the target
        toward the camera (the viewing direction is its negation)."""
        return self.R[:, 2, :, None]

    # -- rigid changes (each returns a new extrinsics) --
    def _update_R_t(self, R, t):
        out = CameraExtrinsics._from_R_t(R, t, self.backend)
        out._base_change = self._base_change
        return out

    def translate(self, t):
        """Move the camera by ``t`` in world space, its axes unchanged:
        t ← t − R t."""
        t = torch.as_tensor(t, dtype=self.dtype,
                            device=self.device).reshape(-1, 3)
        return self._update_R_t(
            self.R, self.t[..., 0] - torch.einsum("cij,cj->ci", self.R, t))

    def rotate(self, yaw=None, pitch=None, roll=None):
        """Rotate in camera space by yaw (about up), pitch (about right) and
        roll (about forward), in that order."""
        c = len(self)
        rot = torch.eye(3, dtype=self.dtype, device=self.device).expand(
            c, 3, 3)

        def axis_rot(angle, axis):
            angle = torch.as_tensor(angle, dtype=self.dtype,
                                    device=self.device).expand(c)
            cos, sin = torch.cos(angle), torch.sin(angle)
            one, zero = torch.ones_like(cos), torch.zeros_like(cos)
            if axis == 0:     # pitch: about x, right
                rows = [[one, zero, zero], [zero, cos, sin],
                        [zero, -sin, cos]]
            elif axis == 1:   # yaw: about y, up
                rows = [[cos, zero, -sin], [zero, one, zero],
                        [sin, zero, cos]]
            else:             # roll: about z, forward
                rows = [[cos, -sin, zero], [sin, cos, zero],
                        [zero, zero, one]]
            return torch.stack([torch.stack(r, dim=-1) for r in rows],
                               dim=-2)

        if yaw is not None:
            rot = axis_rot(yaw, 1) @ rot
        if pitch is not None:
            rot = axis_rot(pitch, 0) @ rot
        if roll is not None:
            rot = axis_rot(roll, 2) @ rot
        return self._update_R_t(rot @ self.R,
                                torch.einsum("cij,cj->ci", rot,
                                             self.t[..., 0]))

    def move_right(self, amount):
        return self._shift_cam([amount, 0.0, 0.0])

    def move_up(self, amount):
        return self._shift_cam([0.0, amount, 0.0])

    def move_forward(self, amount):
        """t ← t − e_z·amount: along the camera's forward axis."""
        return self._shift_cam([0.0, 0.0, amount])

    def _shift_cam(self, delta_cam):
        delta = torch.as_tensor(delta_cam, dtype=self.dtype,
                                device=self.device)
        return self._update_R_t(self.R, self.t[..., 0] - delta[None, :])

    def change_coordinate_system(self, basis_change):
        """Apply a (3, 3) permutation or reflection of the world axes:
        R ← R Pᵀ, t unchanged."""
        p = torch.as_tensor(basis_change, dtype=self.dtype,
                            device=self.device)
        out = self._update_R_t(self.R @ p.T[None], self.t[..., 0])
        prev = (np.eye(3) if self._base_change is None
                else np.asarray(self._base_change))
        out._base_change = tuple(
            tuple(float(x) for x in row)
            for row in p.detach().cpu().double().numpy() @ prev)
        return out

    @property
    def basis_change_matrix(self):
        """The accumulated change of coordinate system (3, 3)."""
        if self._base_change is None:
            return torch.eye(3, dtype=self.dtype, device=self.device)
        return torch.tensor(self._base_change, dtype=self.dtype,
                            device=self.device)

    def reset_coordinate_system(self):
        """Undo every :meth:`change_coordinate_system`."""
        if self._base_change is None:
            return self
        out = self.change_coordinate_system(self.basis_change_matrix.T)
        out._base_change = None
        return out

    @classmethod
    def available_backends(cls):
        """Names of the parameterizations."""
        return (*_BUILTIN, *_BACKEND_REGISTRY.keys())

    @classmethod
    def cat(cls, extrinsics):
        """Concatenate same-backend extrinsics along the batch dim; the
        coordinate system is the first's."""
        first = extrinsics[0]
        for other in extrinsics[1:]:
            if other.backend != first.backend:
                raise ValueError("cat needs same-backend extrinsics")
        params = torch.cat([e.params for e in extrinsics], dim=0)
        return cls(params, backend=first.backend,
                   base_change=first._base_change)

    def __getitem__(self, item):
        return CameraExtrinsics(
            self.params[item].reshape(-1, self.params.shape[-1]),
            backend=self.backend, base_change=self._base_change)

    def __repr__(self):
        return (f"CameraExtrinsics(num_cameras={len(self)}, "
                f"backend={self.backend!r})")

    def named_params(self):
        """Per camera, {"R": (3, 3), "t": (3,)} as numpy."""
        R = self.R.detach().cpu().numpy()
        t = self.t.detach().cpu().numpy()
        return [{"R": R[i], "t": t[i, :, 0]} for i in range(len(self))]

    # -- the differentiable parameters --
    def parameters(self):
        """The backend's parameter tensor (C, P)."""
        return self.params

    def param_idx(self, param):
        """Indices of ``param`` (an :class:`ExtrinsicsParamsDefEnum` or its
        name) in the params of this backend."""
        if isinstance(param, str):
            param = ExtrinsicsParamsDefEnum[param]
        if self.backend == "matrix_se3":
            return (list(range(9)) if param == ExtrinsicsParamsDefEnum.R
                    else [9, 10, 11])
        if self.backend == "matrix_6dof_rotation":
            return (list(range(6)) if param == ExtrinsicsParamsDefEnum.R
                    else [6, 7, 8])
        rep = get_backend(self.backend)
        if rep is None or not hasattr(rep, "param_idx"):
            raise ValueError(
                f"backend {self.backend!r} does not define param_idx")
        return rep.param_idx(param)

    def gradient_mask(self, *args):
        """Bool mask over :meth:`parameters` selecting the named params
        (the camera axes R are masked together). Multiply a gradient by it,
        or register it as a hook: ``params.register_hook(lambda g: g *
        mask)``."""
        mask = torch.zeros(self.params.shape, dtype=torch.bool,
                           device=self.device)
        for param in args:
            mask[:, self.param_idx(param)] = True
        return mask

    def to_dict(self):
        """JSON-writable constructor dict; :meth:`from_dict` reads it."""
        out = {"classname": "CameraExtrinsics",
               "backend": self.backend,
               "params": self.params.detach().cpu().tolist()}
        if self._base_change is not None:
            out["base_change"] = [list(r) for r in self._base_change]
        return out

    def as_dict(self):
        """Alias of :meth:`to_dict`."""
        return self.to_dict()

    @classmethod
    def from_dict(cls, d, dtype=torch.float32, device="cpu"):
        if d.get("classname") != "CameraExtrinsics":
            raise ValueError(
                f"not a CameraExtrinsics dict: {d.get('classname')}")
        bc = d.get("base_change")
        if bc is not None:
            bc = tuple(tuple(float(x) for x in row) for row in bc)
        return cls(torch.tensor(d["params"], dtype=dtype, device=device),
                   backend=d["backend"], base_change=bc)


def allclose(input, other, rtol=1e-05, atol=1e-08, equal_nan=False):
    """Two extrinsics of one backend with close params."""
    return (input.backend == other.backend
            and input.params.shape == other.params.shape
            and bool(torch.allclose(input.params.detach().cpu(),
                                    other.params.detach().cpu(), rtol=rtol,
                                    atol=atol, equal_nan=equal_nan)))
