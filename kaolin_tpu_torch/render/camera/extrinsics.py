"""Camera extrinsics: the world → camera rigid transform.

Counterpart of ``kaolin_tpu/render/camera/extrinsics.py`` with its
``matrix_se3`` backend: ``params`` is the (C, 12) tensor of the flattened
rotation rows followed by the translation.
"""

import torch

__all__ = ["CameraExtrinsics"]


def _to_batched_3(x, dtype, device):
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.dim() <= 2 and x.numel() % 3 == 0:
        x = x.reshape(-1, 3)
    return x[None] if x.dim() == 1 else x


def _eye4(c, dtype, device):
    return torch.eye(4, dtype=dtype, device=device).repeat(c, 1, 1)


class CameraExtrinsics:
    """Batched world → camera transform: x_cam = R x_world + t."""

    def __init__(self, params, backend="matrix_se3"):
        if backend != "matrix_se3":
            raise NotImplementedError(
                f"extrinsics backend {backend!r}: only 'matrix_se3' is "
                "ported")
        self.params = params
        self.backend = backend

    @classmethod
    def _from_R_t(cls, R, t, backend="matrix_se3"):
        return cls(torch.cat([R.reshape(-1, 9), t.reshape(-1, 3)], dim=-1),
                   backend=backend)

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

    @property
    def R(self):
        """(C, 3, 3) rotation."""
        return self.params[:, :9].reshape(-1, 3, 3)

    @property
    def t(self):
        """(C, 3, 1) translation."""
        return self.params[:, -3:, None]

    def __len__(self):
        return self.params.shape[0]

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

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

    def __repr__(self):
        return (f"CameraExtrinsics(num_cameras={len(self)}, "
                f"backend={self.backend!r})")
