"""SimplicitsSolver: the coupled soft/rigid time stepper.

Counterpart of ``kaolin_tpu/experimental/newton/solver.py``. A step
detects the contacts at the step-start positions, refreshes the lagged
friction norms, puts the new force into a copy of the scene's functional
step constants and runs that step, eagerly.
"""

import torch

from kaolin_tpu_torch.experimental.newton.collisions import (
    ParticleShapeSoftContact,
)
from kaolin_tpu_torch.experimental.newton.model import (
    SimplicitsModel,
    SimplicitsState,
)

__all__ = ["SimplicitsSolver"]


class SimplicitsSolver:
    """Advances a :class:`SimplicitsModel` one implicit step at a time.
    The step is differentiable by ``torch.autograd`` when the scene is
    (``finalize(requires_grad=True)``), and runs without autograd
    otherwise."""

    def __init__(self, model: SimplicitsModel):
        self.model = model
        self._step, self._consts = \
            model.simplicits_scene.build_functional_step()
        self._force_idx = None
        for i, (obj, _c) in enumerate(self._consts["pt_forces"]):
            if isinstance(obj, ParticleShapeSoftContact):
                self._force_idx = i

    def _prepare(self, consts, state):
        """The step's constants with the contact force prepared for
        ``state``: contacts detected at its positions, the lagged friction
        norms refreshed there, the rigid poses taken from it."""
        if self._force_idx is None:
            return consts
        pts = consts["pts"]
        force, coeff = consts["pt_forces"][self._force_idx]
        force = force.with_step_state(state.particle_q, shapes=state.shapes)
        if force.friction_lagged:
            force = force.update_lagged_body_contact_force_norm(
                state.particle_q - pts, pts)
        pt_forces = list(consts["pt_forces"])
        pt_forces[self._force_idx] = (force, coeff)
        return dict(consts, pt_forces=pt_forces)

    def step(self, state_in: SimplicitsState, state_out=None, control=None,
             contacts=None, dt=None) -> SimplicitsState:
        """One coupled implicit step → the new state. ``state_out``,
        ``control`` and ``contacts`` are taken for the API's sake: the new
        state is returned, Simplicits reads no control, and the contacts
        are detected from ``state_in``. ``dt`` must equal the scene's
        timestep, else ``ValueError``."""
        del state_out, control, contacts
        scene = self.model.simplicits_scene
        if dt is not None and abs(float(dt) - scene.timestep) > 1e-12:
            raise ValueError(
                f"dt={dt} differs from the scene timestep {scene.timestep}; "
                "rebuild the model with this timestep")
        with torch.set_grad_enabled(scene.differentiable
                                    and torch.is_grad_enabled()):
            consts = self._prepare(self._consts, state_in)
            z, z_prev, z_dot = self._step(consts, state_in.sim_z,
                                          state_in.sim_z_prev,
                                          state_in.sim_z_dot)
            q = self.model.sim_z_to_full(z)
            qd = self.model.sim_z_dot_to_full(z_dot)
        # mirror the solver's state on the scene's side
        scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = z, z_prev, z_dot
        scene.current_sim_step += 1
        return SimplicitsState(sim_z=z, sim_z_prev=z_prev, sim_z_dot=z_dot,
                               particle_q=q, particle_qd=qd,
                               shapes=state_in.shapes)
