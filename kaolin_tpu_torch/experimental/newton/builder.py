"""SimplicitsModelBuilder: assembles a coupled soft/rigid model.

Counterpart of ``kaolin_tpu/experimental/newton/builder.py``. The builder
owns a minimal rigid collider set (:class:`RigidShapes`) and wires the
particle ↔ shape soft-contact force into the scene's force registry under
``"newton_soft_collisions"`` with the reference's default coefficient
0.001.
"""

import numpy as np
import torch

from kaolin_tpu_torch.experimental.newton.collisions import (
    ParticleShapeSoftContact,
)
from kaolin_tpu_torch.experimental.newton.model import SimplicitsModel
from kaolin_tpu_torch.experimental.newton.shapes import (
    BOX,
    PLANE,
    SPHERE,
    RigidShapes,
)

__all__ = ["SimplicitsModelBuilder"]

_AXIS = {"x": 0, "y": 1, "z": 2, 0: 0, 1: 1, 2: 2}


class SimplicitsModelBuilder:
    """Deferred construction of a :class:`SimplicitsModel`."""

    def __init__(self, up_axis="z", gravity=-9.81):
        self.up_axis = _AXIS[up_axis if not isinstance(up_axis, str)
                             else up_axis.lower()]
        self.gravity = float(gravity)
        self._pending_objects = []
        self._pending_boundary_conditions = []
        self._pending_collisions = None
        # (kind, pos, quat, lin_v, ang_v, com, size, ke, kf, mu)
        self._shapes = []
        self._contact_kwargs = {}

    # -- soft bodies --
    def add_simplicits_object(self, sim_object, num_qp=None,
                              init_transform=None, is_kinematic=False,
                              renderable_pts=None):
        self._pending_objects.append(
            (sim_object, num_qp, init_transform, is_kinematic,
             renderable_pts))
        return len(self._pending_objects) - 1

    def add_simplicits_collisions(self, collision_particle_radius=0.1,
                                  detection_ratio=1.5,
                                  impenetrable_barrier_ratio=0.25,
                                  collision_penalty=1000.0,
                                  max_contact_pairs=10000, friction=0.5):
        """Soft-soft collisions, enabled at :meth:`finalize`."""
        self._pending_collisions = (
            collision_particle_radius, detection_ratio,
            impenetrable_barrier_ratio, collision_penalty,
            max_contact_pairs, friction)

    def add_simplicits_object_boundary_condition(self, obj_idx, name, fcn,
                                                 bdry_penalty=10000.0,
                                                 pinned_x=None):
        """A boundary condition, set at :meth:`finalize`."""
        self._pending_boundary_conditions.append(
            (obj_idx, name, fcn, bdry_penalty, pinned_x))

    # -- rigid shapes (the external engine's shape API, minimal) --
    def _add_shape(self, kind, pos, quat, size, ke, kf, mu, lin_vel, ang_vel):
        if quat is None:
            quat = (0.0, 0.0, 0.0, 1.0)
        self._shapes.append((kind, tuple(pos), tuple(quat),
                             tuple(lin_vel), tuple(ang_vel), (0.0, 0.0, 0.0),
                             tuple(size), float(ke), float(kf), float(mu)))
        return len(self._shapes) - 1

    def add_ground_plane(self, height=0.0, ke=1.0e3, kf=1.0e3, mu=0.5):
        """A rigid half-space with its normal +up at ``height`` along the
        up axis."""
        pos = [0.0, 0.0, 0.0]
        pos[self.up_axis] = float(height)
        # the plane's normal is the body's +z: rotate it onto the up axis
        quats = {0: (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)),
                 1: (-np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)),
                 2: (0.0, 0.0, 0.0, 1.0)}
        return self._add_shape(PLANE, pos, quats[self.up_axis],
                               (0.0, 0.0, 0.0), ke, kf, mu,
                               (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))

    def add_shape_sphere(self, pos, radius, quat=None, ke=1.0e3, kf=1.0e3,
                         mu=0.5, lin_vel=(0.0, 0.0, 0.0),
                         ang_vel=(0.0, 0.0, 0.0)):
        return self._add_shape(SPHERE, pos, quat, (radius, 0.0, 0.0),
                               ke, kf, mu, lin_vel, ang_vel)

    def add_shape_box(self, pos, half_extents, quat=None, ke=1.0e3, kf=1.0e3,
                      mu=0.5, lin_vel=(0.0, 0.0, 0.0),
                      ang_vel=(0.0, 0.0, 0.0)):
        return self._add_shape(BOX, pos, quat, half_extents, ke, kf, mu,
                               lin_vel, ang_vel)

    def configure_soft_contact(self, **kwargs):
        """Extra keywords of :class:`ParticleShapeSoftContact` (e.g.
        ``friction_use_lagged_body_contact_force_norm``,
        ``particle_radius``, ``velocity_penalty_kv_scale``,
        ``coeff_of_restitution``)."""
        self._contact_kwargs.update(kwargs)

    # -- finalize --
    def finalize(self, device=None, requires_grad=False,
                 timestep=0.03, **scene_kwargs) -> SimplicitsModel:
        """The model, its scene on ``device`` (the card when None).
        ``requires_grad=True`` makes the scene differentiable (Newton's
        fixed trip), so ``torch.autograd`` flows through the steps."""
        if requires_grad:
            scene_kwargs.setdefault("differentiable", True)
        from kaolin_tpu_torch.physics.simplicits import SimplicitsScene

        model = SimplicitsModel(device)
        model.simplicits_scene = SimplicitsScene(
            timestep=timestep, device=model.device, **scene_kwargs)
        scene = model.simplicits_scene

        for args in self._pending_objects:
            sim_object, num_qp, init_transform, is_kinematic, rpts = args
            scene.add_object(sim_object, num_qp=num_qp,
                             init_transform=init_transform,
                             is_kinematic=is_kinematic,
                             renderable_pts=rpts)

        if not self._pending_objects:
            if (self._shapes or self._pending_boundary_conditions
                    or self._pending_collisions is not None):
                raise ValueError(
                    "finalize() called with rigid shapes, boundary conditions "
                    "or collisions but no simplicits objects — add at least "
                    "one soft object via add_simplicits_object() first, or "
                    "these settings would be silently dropped.")
            return model

        acc_gravity = [0.0, 0.0, 0.0]
        acc_gravity[self.up_axis] = -self.gravity
        scene.set_scene_gravity(tuple(acc_gravity))

        for (obj_idx, name, fcn, bdry_penalty, pinned_x) in \
                self._pending_boundary_conditions:
            scene.set_object_boundary_condition(obj_idx, name, fcn,
                                                bdry_penalty, pinned_x)
        if self._pending_collisions is not None:
            scene.enable_collisions(*self._pending_collisions)

        if self._shapes:
            cols = list(zip(*self._shapes))
            model.shapes = RigidShapes(
                cols[0], *(np.asarray(c, np.float32) for c in cols[1:]),
                device=model.device)

        model.simplicits_particle_start = 0
        model.simplicits_particle_end = scene.total_qp

        # register the coupling force
        if "newton_soft_collisions" not in scene.force_dict["pt_wise"]:
            kwargs = dict(particle_ke=model.soft_contact_ke,
                          particle_mu=model.soft_contact_mu,
                          friction_use_lagged_body_contact_force_norm=False)
            kwargs.update(self._contact_kwargs)
            force = ParticleShapeSoftContact(
                model.shapes, torch.ones_like(scene.sim_vols),
                dt=scene.timestep, **kwargs)
            scene.force_dict["pt_wise"]["newton_soft_collisions"] = {
                "object": force, "coeff": 0.001}
            scene._invalidate()
        return model
