"""SimplicitsModel and SimplicitsState: the data model of the Newton bridge.

Counterpart of ``kaolin_tpu/experimental/newton/model.py``. The model owns
a :class:`SimplicitsScene` and the rigid-shape set; the state is a tuple of
tensors and the shapes.
"""

from typing import NamedTuple, Optional

import torch

from kaolin_tpu_torch.experimental.newton.collisions import (
    ParticleShapeSoftContact,
)
from kaolin_tpu_torch.experimental.newton.shapes import RigidShapes

__all__ = ["SimplicitsModel", "SimplicitsState"]


class SimplicitsState(NamedTuple):
    """The flattened Simplicits DOFs, the quadrature particles' world
    positions ``particle_q`` and velocities ``particle_qd`` (N, 3), and the
    rigid bodies' current poses and velocities ``shapes``."""
    sim_z: torch.Tensor
    sim_z_prev: torch.Tensor
    sim_z_dot: torch.Tensor
    particle_q: torch.Tensor
    particle_qd: torch.Tensor
    shapes: Optional[RigidShapes]


class SimplicitsModel:
    """Holds the Simplicits scene, the rigid shapes and the registered
    soft-contact force. The scene is built on ``device``, the card when it
    is None (raising without one)."""

    def __init__(self, device=None):
        from kaolin_tpu_torch.physics.simplicits import SimplicitsScene
        self.simplicits_scene = SimplicitsScene(device=device)
        self.device = self.simplicits_scene.device
        self.shapes = RigidShapes.empty(device=self.device)
        self.simplicits_particle_start = None
        self.simplicits_particle_end = None
        self.soft_contact_ke = 1.0e3
        self.soft_contact_mu = 0.5

    @property
    def contact_force(self) -> ParticleShapeSoftContact:
        entry = self.simplicits_scene.force_dict["pt_wise"].get(
            "newton_soft_collisions")
        return None if entry is None else entry["object"]

    def sim_z_to_full(self, sim_z):
        """Reduced DOFs → world particle positions (N, 3)."""
        scene = self.simplicits_scene
        return (scene.sim_B @ sim_z).reshape(-1, 3) + scene.sim_pts

    def sim_z_dot_to_full(self, sim_z_dot):
        """Reduced DOF rates → world particle velocities (N, 3)."""
        return (self.simplicits_scene.sim_B @ sim_z_dot).reshape(-1, 3)

    def state(self, requires_grad=None) -> SimplicitsState:
        """A new state from the scene's. ``requires_grad`` is taken for the
        API's sake: a model finalized with ``requires_grad=True`` steps
        differentiably, and the caller marks the tensors it differentiates
        by."""
        del requires_grad
        scene = self.simplicits_scene
        if scene.sim_z is None:
            raise RuntimeError("add objects and finalize before state()")
        z = scene.sim_z
        zd = torch.zeros_like(z)
        return SimplicitsState(
            sim_z=z, sim_z_prev=torch.zeros_like(z), sim_z_dot=zd,
            particle_q=self.sim_z_to_full(z),
            particle_qd=self.sim_z_dot_to_full(zd), shapes=self.shapes)
