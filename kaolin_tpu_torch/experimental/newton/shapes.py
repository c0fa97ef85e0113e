"""Minimal rigid-shape collider set of the Newton-engine bridge.

Counterpart of ``kaolin_tpu/experimental/newton/shapes.py``. The reference
bridge couples Simplicits particles to shapes of the external NVIDIA Newton
engine, whose ``collide()`` gives per-(particle, shape) soft contacts
(closest surface point and normal). Here a struct of tensors of planes,
spheres and boxes answers those queries analytically, for all (particle,
shape) pairs at once: the few shapes are looped over in Python.
"""

import numpy as np
import torch

from kaolin_tpu_torch.math.quat.quaternion import quat_conjugate, quat_rotate
from kaolin_tpu_torch.utils.backend import first_tensor, resolve_device

__all__ = ["RigidShapes", "PLANE", "SPHERE", "BOX"]

PLANE, SPHERE, BOX = 0, 1, 2


class RigidShapes:
    """Rigid colliders as float32 tensors on one device.

    Attributes (S shapes):
        kinds: tuple of ints (PLANE / SPHERE / BOX).
        pos: (S, 3) world positions; quat: (S, 4) xyzw unit orientations.
        lin_vel / ang_vel: (S, 3) world-frame body velocities.
        com: (S, 3) body-frame center of mass.
        size: (S, 3): the sphere's radius in [:, 0]; the box's half
            extents; unused for planes (the plane is z = 0 in the body
            frame, normal +z).
        ke / kf / mu: (S,) contact stiffness, friction stiffness, friction
            coefficient.

    The tensors go to ``device``, else where the first tensor argument
    lies, else to the card (raising without one).
    """

    def __init__(self, kinds, pos, quat, lin_vel, ang_vel, com, size, ke, kf,
                 mu, device=None):
        arrays = (pos, quat, lin_vel, ang_vel, com, size, ke, kf, mu)
        t = first_tensor(*arrays)
        if device is None and t is not None:
            device = t.device
        device = resolve_device(device, "RigidShapes")
        self.kinds = tuple(int(k) for k in kinds)
        (self.pos, self.quat, self.lin_vel, self.ang_vel, self.com,
         self.size, self.ke, self.kf, self.mu) = (
            torch.as_tensor(np.asarray(a, np.float32) if not
                            isinstance(a, torch.Tensor) else a,
                            dtype=torch.float32, device=device)
            for a in arrays)

    @property
    def device(self):
        return self.pos.device

    @property
    def num_shapes(self):
        return len(self.kinds)

    @classmethod
    def empty(cls, device=None):
        z = np.zeros((0, 3), np.float32)
        return cls((), z, np.zeros((0, 4), np.float32), z, z, z, z,
                   np.zeros((0,)), np.zeros((0,)), np.zeros((0,)),
                   device=device)

    # -- closest-point queries in the body frame: the plane z = 0, the
    #    sphere at the origin, the box centred at the origin --
    def _closest_local(self, kind, p_local, size):
        if kind == PLANE:
            cp = p_local.clone()
            cp[..., 2] = 0.0
            n = torch.zeros_like(p_local)
            n[..., 2] = 1.0
            return cp, n
        if kind == SPHERE:
            d = torch.linalg.vector_norm(p_local, dim=-1, keepdim=True)
            n = p_local / torch.clamp(d, min=1e-9)
            return size[0] * n, n
        # the box: outside, clamp to it; inside, push to the nearest face
        # along the axis of least gap (the first on ties), +1 at sign 0
        he = size
        clamped = torch.minimum(torch.maximum(p_local, -he), he)
        outside = torch.any(torch.abs(p_local) > he, dim=-1, keepdim=True)
        diff = p_local - clamped
        n_out = diff / torch.clamp(
            torch.linalg.vector_norm(diff, dim=-1, keepdim=True), min=1e-9)
        gap = he - torch.abs(p_local)
        ax = torch.argmin(gap, dim=-1, keepdim=True)
        sign = torch.sign(torch.gather(p_local, -1, ax))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        n_in = torch.nn.functional.one_hot(ax[..., 0], 3).to(
            p_local.dtype) * sign
        cp_in = p_local + n_in * torch.gather(gap, -1, ax)
        return (torch.where(outside, clamped, cp_in),
                torch.where(outside, n_out, n_in))

    def detect(self, particle_pos):
        """All-pairs soft contacts of (N, 3) particle positions → a dict of
        (N, S, 3) tensors: ``bx`` the closest surface points, ``normal`` the
        outward normals and ``bv`` the rigid velocity at the contact
        (v + ω × r), all in the world frame. They stay fixed through one
        implicit solve, as the Newton engine's per-step ``collide()``
        output does."""
        outs_bx, outs_n = [], []
        for s, kind in enumerate(self.kinds):
            q = self.quat[s][None]
            local = quat_rotate(quat_conjugate(q),
                                particle_pos - self.pos[s][None])
            cp, n = self._closest_local(kind, local, self.size[s])
            outs_bx.append(self.pos[s][None] + quat_rotate(q, cp))
            outs_n.append(quat_rotate(q, n))
        bx = torch.stack(outs_bx, dim=1)
        normal = torch.stack(outs_n, dim=1)
        com_w = self.pos + quat_rotate(self.quat, self.com)
        r = bx - com_w[None]
        bv = self.lin_vel[None] + torch.linalg.cross(
            torch.broadcast_to(self.ang_vel[None], r.shape), r, dim=-1)
        return {"bx": bx, "normal": normal, "bv": bv}
