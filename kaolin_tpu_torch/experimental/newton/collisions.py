"""Particle ↔ rigid-shape soft contact: the force of the Newton bridge.

Counterpart of ``kaolin_tpu/experimental/newton/collisions.py``. For each
(particle i, shape s) pair, with the contact geometry (normal n, surface
point bx, rigid velocity bv) fixed for one step:

* penetration d = n·(pos − bx) − radius, active where d ≤ 0;
* collision ½·ke·d², ke = ½(particle_ke + shape_ke);
* IPC friction μ·‖f_n‖·f₀(‖u‖), u the tangential part of the relative
  translation (pos − prev_pos − bv·dt), f₀ the IPC smoothing with
  ε_u = friction_epsilon·dt, and ‖f_n‖ either the current ke·|d| or a norm
  lagged between solves (``friction_use_lagged_body_contact_force_norm``;
  with lagging, the gradient is the exact derivative of the energy);
* an optional restitution penalty ½·k_v·((1 + e)·max(−vₙ, 0))².

All pairs are evaluated densely ((N, S), S small) and masked. The class
keeps the scene's point-wise force protocol (``energy``, ``gradient`` and
``hessian`` of (dx, x0, coeff)), so it registers in
``SimplicitsScene.force_dict["pt_wise"]`` under ``"newton_soft_collisions"``.
"""

import copy

import torch

from kaolin_tpu_torch.experimental.newton.shapes import RigidShapes

__all__ = ["ParticleShapeSoftContact", "build_orthonormal_basis"]


def build_orthonormal_basis(n):
    """Two unit tangents orthogonal to n (..., 3). Any orthonormal basis
    gives the same friction energies (u enters through norms and
    projections only)."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    helper = torch.where(torch.abs(n[..., 2:3]) < 0.9, z, x)
    e0 = torch.linalg.cross(helper.expand_as(n), n, dim=-1)
    e0 = e0 / torch.clamp(torch.linalg.vector_norm(e0, dim=-1, keepdim=True),
                          min=1e-9)
    return e0, torch.linalg.cross(n, e0, dim=-1)


class ParticleShapeSoftContact:
    """Soft contact between the scene's quadrature particles and rigid
    shapes.

    Per-step inputs, set by the solver before each implicit solve:
    ``shapes``, ``contacts`` (the detection's dict), ``prev_pos`` (N, 3) the
    step-start positions and ``lagged_norm`` (N,). The methods that change
    them return a new force (a shallow copy) and leave this one as it is.
    """

    def __init__(self, shapes: RigidShapes, integration_pt_volume,
                 dt, particle_radius=0.0, particle_ke=1.0e3,
                 particle_mu=0.5,
                 friction_use_lagged_body_contact_force_norm=True,
                 velocity_penalty_kv_scale=0.0, friction_epsilon=1e-2,
                 coeff_of_restitution=0.0, contacts=None, prev_pos=None,
                 lagged_norm=None):
        vols = torch.as_tensor(integration_pt_volume, dtype=torch.float32)
        n = vols.shape[0]
        self.shapes = shapes
        self.vols = vols
        self.dt = float(dt)
        self.particle_radius = float(particle_radius)
        self.particle_ke = float(particle_ke)
        self.particle_mu = float(particle_mu)
        self.friction_lagged = bool(
            friction_use_lagged_body_contact_force_norm)
        self.velocity_penalty_kv = float(velocity_penalty_kv_scale) \
            * float(particle_ke)
        self.friction_epsilon = float(friction_epsilon)
        self.coeff_of_restitution = float(coeff_of_restitution)
        self.contacts = contacts
        self.prev_pos = (vols.new_zeros((n, 3)) if prev_pos is None
                         else prev_pos)
        self.lagged_norm = (vols.new_zeros((n,)) if lagged_norm is None
                            else lagged_norm)

    def _replace(self, **kw):
        obj = copy.copy(self)
        for k, v in kw.items():
            setattr(obj, k, v)
        return obj

    # -- per-step preparation (the solver's side) --
    def with_step_state(self, prev_pos, shapes=None):
        """A new force with these step-start positions (and shape poses),
        its contacts detected at ``prev_pos``."""
        s = shapes if shapes is not None else self.shapes
        contacts = s.detect(prev_pos) if s.num_shapes else None
        return self._replace(shapes=s, prev_pos=prev_pos, contacts=contacts)

    def update_lagged_body_contact_force_norm(self, dx, x0):
        """A new force with the lagged normal-force magnitudes refreshed:
        the sum over a particle's active pairs of ke·|d| at the current
        positions."""
        if self.contacts is None:
            return self
        ke, _, _ = self._pair_materials()
        d = self._penetration(dx + x0)
        norm_pair = torch.where(d <= 0, ke * torch.abs(d),
                                torch.zeros_like(d))
        return self._replace(lagged_norm=torch.sum(norm_pair, dim=1))

    # -- pair quantities --
    def _pair_materials(self):
        ke = 0.5 * (self.particle_ke + self.shapes.ke)[None]
        mu = 0.5 * (self.particle_mu + self.shapes.mu)[None]
        return ke, mu, self.shapes.kf[None]

    def _penetration(self, pos):
        c = self.contacts
        return (torch.sum(c["normal"] * (pos[:, None] - c["bx"]), dim=-1)
                - self.particle_radius)

    def _friction_terms(self, pos):
        c = self.contacts
        rel = (pos - self.prev_pos)[:, None] - c["bv"] * self.dt
        n = c["normal"]
        e0, e1 = build_orthonormal_basis(n)
        u0 = torch.sum(e0 * rel, dim=-1)
        u1 = torch.sum(e1 * rel, dim=-1)
        u_norm = torch.sqrt(u0 * u0 + u1 * u1 + 1e-20)
        eps_u = self.friction_epsilon * self.dt
        vn = torch.sum(n * rel, dim=-1) / self.dt
        return n, e0, e1, u0, u1, u_norm, eps_u, vn

    def _force_norm(self, ke, d):
        if self.friction_lagged:
            return self.lagged_norm[:, None]
        return ke * torch.abs(d)

    # -- the scene's force protocol: dx (N, 3) displacements, x0 (N, 3)
    #    rest positions --
    def energy(self, dx, x0, coeff=1.0):
        if self.contacts is None:
            return dx.new_zeros(())
        pos = dx + x0
        ke, mu, _ = self._pair_materials()
        d = self._penetration(pos)
        collision = 0.5 * ke * d * d
        n, e0, e1, u0, u1, u_norm, eps_u, vn = self._friction_terms(pos)
        r = u_norm / eps_u
        f0 = torch.where(u_norm > eps_u, u_norm - eps_u / 3.0,
                         u_norm * r * (1.0 - r / 3.0))
        friction = mu * self._force_norm(ke, d) * f0
        vterm = (1.0 + self.coeff_of_restitution) * torch.clamp(-vn, min=0.0)
        vel = 0.5 * self.velocity_penalty_kv * vterm * vterm
        e = self.vols[:, None] * (collision + friction + vel)
        return coeff * torch.sum(torch.where(d <= 0, e, torch.zeros_like(e)))

    def gradient(self, dx, x0, coeff=1.0):
        """dE/dpos per particle (N, 3), summed over its shape contacts."""
        if self.contacts is None:
            return torch.zeros_like(dx)
        pos = dx + x0
        ke, mu, _ = self._pair_materials()
        d = self._penetration(pos)
        n, e0, e1, u0, u1, u_norm, eps_u, vn = self._friction_terms(pos)
        collision_g = n * (ke * d)[..., None]
        f1_over = torch.where(u_norm > eps_u, 1.0 / u_norm,
                              (2.0 - u_norm / eps_u) / eps_u)
        fn = self._force_norm(ke, d)
        tang = e0 * u0[..., None] + e1 * u1[..., None]
        friction_g = (mu * fn * f1_over)[..., None] * tang
        neg_vn = -vn
        kfac = self.velocity_penalty_kv \
            * (1.0 + self.coeff_of_restitution) ** 2
        vel_g = -(kfac * neg_vn / self.dt)[..., None] * n
        vel_g = torch.where((neg_vn > 0)[..., None], vel_g,
                            torch.zeros_like(vel_g))
        g = self.vols[:, None, None] * (collision_g + friction_g + vel_g)
        return coeff * torch.sum(torch.where((d <= 0)[..., None], g,
                                             torch.zeros_like(g)), dim=1)

    def hessian(self, dx, x0, coeff=1.0):
        """Per-particle 3x3 Hessian blocks (N, 3, 3), Gauss-Newton: the
        derivative of the force norm by the position is dropped."""
        if self.contacts is None:
            return dx.new_zeros(dx.shape[:1] + (3, 3))
        pos = dx + x0
        ke, mu, _ = self._pair_materials()
        d = self._penetration(pos)
        n, e0, e1, u0, u1, u_norm, eps_u, vn = self._friction_terms(pos)
        nn = n[..., :, None] * n[..., None, :]
        collision_h = ke[..., None, None] * nn
        f1_over = torch.where(u_norm > eps_u, 1.0 / u_norm,
                              (2.0 - u_norm / eps_u) / eps_u)
        fn = self._force_norm(ke, d)
        # the world-space tangential projector T·(f1 I2 + outer)·Tᵀ
        tang_proj = (e0[..., :, None] * e0[..., None, :]
                     + e1[..., :, None] * e1[..., None, :])
        uu = e0 * u0[..., None] + e1 * u1[..., None]
        uu_outer = uu[..., :, None] * uu[..., None, :]
        u_sq = torch.clamp(u0 * u0 + u1 * u1, min=1e-20)
        outer = torch.where(
            (u_norm > eps_u)[..., None, None],
            -(f1_over / u_sq)[..., None, None] * uu_outer,
            -(1.0 / (u_norm * eps_u * eps_u))[..., None, None] * uu_outer)
        friction_h = (mu * fn)[..., None, None] \
            * (f1_over[..., None, None] * tang_proj + outer)
        kfac = self.velocity_penalty_kv \
            * (1.0 + self.coeff_of_restitution) ** 2 / (self.dt * self.dt)
        vel_h = torch.where(((-vn) > 0)[..., None, None], kfac * nn,
                            torch.zeros_like(nn))
        h = self.vols[:, None, None, None] \
            * (collision_h + friction_h + vel_h)
        return coeff * torch.sum(torch.where((d <= 0)[..., None, None], h,
                                             torch.zeros_like(h)), dim=1)
