"""Simplicits contact in plain torch, from the benchmark's inputs alone:
soft cubes stacked on a kinematic plate, stepped by reduced-order implicit
elastodynamics with kaolin's particle contact (kaolin v0.18.0
``physics/common/collisions.py``).

The cubes are :mod:`.simplicits`'s objects (linear blend skinning, the
stable Neo-Hookean energy, gravity, a floor, the kinetic term of implicit
Euler), each in the orthonormal basis of an unpivoted QR of its B, made in
float64. The plate's points stay at rest and carry no DOF. Contact, as
kaolin defines it, for contact radius r and detection ratio ρ:

- detection at the step's start, exact over all pairs of points (in row
  blocks): a pair within 2rρ of each other, not of one object (kaolin
  leaves out a pair of one object whose squared rest distance is under
  r times its self-collision ratio, 1e5: every such pair here) and not of
  two kinematic points; a kinematic point is side b. The normal n and the
  gap g = (p_a − p_b)·n n are taken there and kept for the step, and
  r_c = 2r (r against a kinematic point);
- at a later state, the offset o = Δx_a + g − Δx_b (Δx: the points' motion
  since detection), d = o·n, d̂ = d / r_c, and the slip velocity
  v = (o − d n) / dt. A pair is active for ρ_b < d̂ ≤ 1 (ρ_b the
  impenetrable-barrier ratio); its energy is the quadratic-log barrier
  −(d̂ − 1)² log(d̂ − ρ_b) plus friction μ_n dt h(|v|), with
  μ_n = −μ ∂_d̂ barrier / r_c and h(s) = ν s²/2 + s² (1 − s/3) for s < 1,
  ν s²/2 + s − 1/3 beyond (ν the fluid friction), all times the contact
  stiffness.

A step minimises ½ δᵀMδ + dt² (elastic + gravity + floor + contact) by
Newton's method with the gradient by ``torch.func``, a dense solve and
kaolin's sequential backtracking Armijo search under kaolin's contact step
bounds; then ż = (z − z_k)/dt.

Steps run as a batch of independent frames (:meth:`Stack.steps`): each
frame has its own contacts (padded to the batch's most, the padding
inactive), its own Newton iterations (a frame that has converged is left
as it is) and its own line search (a frame's tries follow its own
decisions), so a frame's step is the step it would take alone, up to the
order of float sums. The check steps many frames from given starts at
once; a run from rest steps a batch of one.

Where this departs from a plain reading of the energy, and why:

- The Hessian. kaolin's contact Hessian is not the energy's own: its
  friction terms differentiate the slip and the normal force apart
  (``_contact_hessian`` writes kaolin's 3 x 3 form out), which makes H not
  symmetric. The rest of H is the energies' own: the Neo-Hookean and floor
  point terms by ``torch.func.hessian`` of each point's energy, reduced by
  each cube's linear maps dF/dz and B, and the kinetic M.
- The solve. kaolin factors H by Cholesky reading its upper triangle (the
  symmetric matrix that triangle defines, which is not H where friction
  acts), and by LU where that factorisation fails or its solution is not
  finite; so does this reference.
- The step bounds. kaolin clamps each DOF of the raw (pre-QR) basis, the
  handles' transforms, by the least bound of the contacts whose LBS row
  reaches it. Here the clamp is made in that basis with the QR's R in
  float64, in every precision: a float32 rotation by a nearly singular
  R⁻¹ would be decided by rounding.
- The step sizes are float64, as kaolin's Python floats, where the port
  makes them by float32 multiplies: they may differ in the last bit.
- The weights are scaled as kaolin's ``add_object`` scales them (see
  :mod:`.simplicits`).

``Stack(cfg, inputs, dtype)`` runs in float32 (the benchmark's check) or
float64 (the check's yardstick of what float32 rounding moves).
"""

import torch

from portbench.reference.simplicits import dfdz_matrix, lame, lbs_matrix

# rows of points tested at once in detection's row blocks
BLOCK = 1024
# frames stepped at once by ``steps_from``
CHUNK = 16


def _neo_hookean(f, mu, lam):
    """The stable Neo-Hookean energy density of F (..., 3, 3)."""
    i1 = (f * f).sum((-2, -1))
    j = (f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2]
                         - f[..., 1, 2] * f[..., 2, 1])
         - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2]
                           - f[..., 1, 2] * f[..., 2, 0])
         + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1]
                           - f[..., 1, 1] * f[..., 2, 0]))
    return mu / 2 * (i1 - 3) + lam / 2 * (j - 1) ** 2 - mu * (j - 1)


def _col(s):
    return s[..., None, None]


class Stack:
    """The cubes, the plate, the operators and the implicit step with
    contact, in the cubes' orthonormal bases (see the module's
    docstring). States are (F, D): F frames of the cubes' D DOFs."""

    def __init__(self, cfg, inputs, dtype=torch.float32):
        self.cfg, self.dtype = cfg, dtype
        self.dt = cfg["timestep"]
        cubes = inputs["cubes"]
        dev = cubes[0]["pts"].device
        self.device = dev
        blocks_b, blocks_f, raw_q, r_blocks = [], [], [], []
        for cube in cubes:
            x0 = cube["pts"]
            norms = torch.clamp(cube["weights"].double().norm(dim=0)
                                .to(x0.dtype), min=1e-10)
            w = cube["weights"] / norms
            dwdx = cube["dwdx"] / norms[:, None]
            b64 = lbs_matrix(x0.double(), w.double())
            q, r = torch.linalg.qr(b64)
            k = torch.linalg.solve_triangular(
                r, torch.eye(r.shape[0], dtype=r.dtype, device=dev),
                upper=True)
            blocks_b.append(q)
            blocks_f.append(dfdz_matrix(x0.double(), w.double(),
                                        dwdx.double()) @ k)
            r_blocks.append(r)
            hom = torch.cat([x0, torch.ones_like(x0[:, :1])], 1)
            # each point's raw factors w ⊗ [x;1]: where they are not 0 its
            # LBS row reaches that handle's DOFs
            raw_q.append((w[:, :, None] * hom[:, None, :]).reshape(
                x0.shape[0], -1))
        self.n_cube = cubes[0]["pts"].shape[0]
        self.n_cubes = len(cubes)
        self.cube_dofs = blocks_b[0].shape[1]
        self.raw_q = torch.cat(raw_q)
        # each cube's own maps (3 Nc, Dc) and (9 Nc, Dc)
        self.b_blocks = [b.to(dtype) for b in blocks_b]
        self.f_blocks = [f.to(dtype) for f in blocks_f]
        self.B64 = torch.block_diag(*blocks_b)
        self.B = self.B64.to(dtype)
        self.dFdz = torch.block_diag(*blocks_f).to(dtype)
        self.R64 = torch.block_diag(*r_blocks)
        self.Rinv64 = torch.linalg.solve_triangular(
            self.R64, torch.eye(self.R64.shape[0], dtype=torch.float64,
                                device=dev), upper=True)
        self.x0 = torch.cat([c["pts"] for c in cubes]).to(dtype)
        self.plate = inputs["plate"].to(dtype)
        n_dyn = self.x0.shape[0]
        self.vol = cfg["appx_vol"] / self.n_cube
        self.mass = cfg["density"] * self.vol
        self.plate_mass = (cfg["plate_density"] * cfg["plate_appx_vol"]
                           / self.plate.shape[0])
        self.mu, lam = lame(cfg["youngs_modulus"], cfg["poisson_ratio"])
        self.lam = lam + self.mu
        self.g = torch.tensor(cfg["gravity"], dtype=dtype, device=dev)
        self.eye = torch.eye(self.B.shape[1], dtype=dtype, device=dev)
        # every point: the cubes', then the plate's
        self.obj = torch.cat([
            torch.arange(self.n_cubes, device=dev).repeat_interleave(
                self.n_cube),
            torch.full((self.plate.shape[0],), self.n_cubes, device=dev)])
        self.kin = torch.cat([
            torch.zeros(n_dyn, dtype=torch.bool, device=dev),
            torch.ones(self.plate.shape[0], dtype=torch.bool, device=dev)])
        self.rest = torch.cat([self.x0, self.plate])

    # -- points and energies --
    def points(self, u):
        """The cubes' deformed points (..., 6N, 3) at states u (..., D)."""
        return self.x0 + (u @ self.B.T).reshape(*u.shape[:-1], -1, 3)

    def _point_energy(self, x):
        """Gravity and floor energy of the cubes' points x (F, 6N, 3) → (F,)."""
        h, axis, k = (self.cfg["floor_height"], self.cfg["floor_axis"],
                      self.cfg["floor_penalty"])
        below = x[..., axis] - h
        floor = k * torch.where(below < 0, below * below, 0.0)
        return self.mass * (x @ self.g).sum(-1) + floor.sum(-1)

    def _defo(self, u):
        """The deformation gradients (F, 6N, 3, 3) at states u (F, D)."""
        return (u @ self.dFdz.T).reshape(u.shape[0], -1, 3, 3) + torch.eye(
            3, dtype=u.dtype, device=u.device)

    def elastic(self, u):
        return self.vol * _neo_hookean(self._defo(u), self.mu,
                                       self.lam).sum(-1)

    def potential(self, u):
        """Elastic + gravity + floor energy of the cubes at states u → (F,)."""
        return self.elastic(u) + self._point_energy(self.points(u))

    def plate_energy(self):
        """The plate's gravity (it lies above the floor): a constant."""
        return self.plate_mass * (self.plate @ self.g).sum()

    # -- contact --
    def detect_one(self, u):
        """The contacts at one state u (D,) (see the module's docstring): a
        dict of the pairs' points, their sides' kinematic flags, normals,
        gaps and target distances r_c."""
        cfg = self.cfg
        pos = torch.cat([self.points(u), self.plate])
        radius = 2.0 * cfg["collision_particle_radius"] * cfg["detection_ratio"]
        immune = cfg["collision_particle_radius"] \
            * cfg["ignore_self_collision_ratio"]
        n = pos.shape[0]
        ia, ib = [], []
        for i0 in range(0, n, BLOCK):
            rows = torch.arange(i0, min(i0 + BLOCK, n), device=pos.device)
            d = pos[rows, None, :] - pos[None, :, :]
            d2 = (d * d).sum(-1)
            r = self.rest[rows, None, :] - self.rest[None, :, :]
            same = (self.obj[rows, None] == self.obj[None, :]) \
                & ((r * r).sum(-1) < immune)
            near = (d2 <= radius * radius) & ~same \
                & (rows[:, None] < torch.arange(n, device=pos.device)[None]) \
                & ~(self.kin[rows, None] & self.kin[None, :])
            a, b = torch.nonzero(near, as_tuple=True)
            ia.append(rows[a])
            ib.append(b)
        ia, ib = torch.cat(ia), torch.cat(ib)
        swap = self.kin[ia] & ~self.kin[ib]
        ia, ib = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
        diff = pos[ia] - pos[ib]
        nrm = diff / torch.clamp(diff.norm(dim=1), min=1e-12)[:, None]
        gaps = (diff * nrm).sum(1, keepdim=True) * nrm
        r_c = torch.where(self.kin[ib], 1.0, 2.0) \
            * cfg["collision_particle_radius"]
        return {"a": ia, "b": ib, "b_kin": self.kin[ib], "n": nrm,
                "gap": gaps, "rc": r_c.to(self.dtype)}

    def detect(self, u):
        """The contacts of each of the states u (F, D), padded to the most
        any frame has: (F, C) tensors and ``valid`` (F, C). A padded slot
        pairs point 0 with itself at gap 0, so it is never active."""
        one = [self.detect_one(x) for x in u]
        c = max(1, max(len(d["a"]) for d in one))
        f, dev = len(one), self.device
        out = {"a": torch.zeros((f, c), dtype=torch.long, device=dev),
               "b": torch.zeros((f, c), dtype=torch.long, device=dev),
               "b_kin": torch.zeros((f, c), dtype=torch.bool, device=dev),
               "valid": torch.zeros((f, c), dtype=torch.bool, device=dev),
               "n": torch.zeros((f, c, 3), dtype=self.dtype, device=dev),
               "gap": torch.zeros((f, c, 3), dtype=self.dtype, device=dev),
               "rc": torch.full((f, c), 2.0 * self.cfg[
                   "collision_particle_radius"], dtype=self.dtype,
                   device=dev)}
        for i, d in enumerate(one):
            k = len(d["a"])
            for key in ("a", "b", "b_kin", "n", "gap", "rc"):
                out[key][i, :k] = d[key]
            out["valid"][i, :k] = True
        return out

    def _rows(self, idx, kin=None):
        """The LBS rows (F, C, 3, D) of points ``idx`` in the cubes' bases:
        0 for a kinematic point."""
        rows = self.B.reshape(-1, 3, self.B.shape[1])
        safe = torch.where(kin, 0, idx) if kin is not None else idx
        out = rows[safe]
        return out if kin is None else torch.where(kin[..., None, None], 0.0,
                                                   out)

    def jacobian(self, con):
        """J = J_a − J_b (F, C, 3, D): the offsets' change with u."""
        return self._rows(con["a"]) - self._rows(con["b"], con["b_kin"])

    def _terms(self, con, jac, du):
        """Offset, normal, d, d̂, the active mask, d̂ − ρ_b (clamped), d̂ − 1
        and the slip velocity of each contact at the motion du (F, D) since
        detection."""
        off = (jac @ du[:, None, :, None])[..., 0] + con["gap"]
        nor = con["n"]
        d = (off * nor).sum(-1)
        d_hat = d / con["rc"]
        rp = self.cfg["impenetrable_barrier_ratio"]
        active = (d_hat > rp) & (d_hat <= 1.0) & con["valid"]
        dp = torch.clamp(d_hat - rp, min=1e-9)
        dc = d_hat - 1.0
        vt = (off - d[..., None] * nor) / self.dt
        return off, nor, d, d_hat, active, dp, dc, vt

    def contact_energy(self, con, jac, du):
        """kaolin's contact energy at the motion du since detection, times
        the contact stiffness → (F,)."""
        cfg = self.cfg
        _, _, _, _, active, dp, dc, vt = self._terms(con, jac, du)
        s = (vt * vt).sum(-1)
        nu = cfg["friction_fluid"]
        # h(|v|) as a function of |v|², so that ``torch.func`` takes its
        # derivatives at v = 0 (h' = 0 there)
        h = 0.5 * nu * s + torch.where(
            s < 1.0, s - torch.clamp(s, min=0.0) ** 1.5 / 3.0,
            torch.sqrt(torch.clamp(s, min=1.0)) - 1.0 / 3.0)
        de = -dc * (2.0 * torch.log(dp) + dc / dp)
        mu_n = -cfg["friction"] * de / con["rc"]
        e = -(dc * dc) * torch.log(dp) + mu_n * self.dt * h
        return cfg["collision_penalty"] * torch.where(active, e, 0.0).sum(-1)

    def _contact_hessian(self, con, jac, du):
        """kaolin's per-contact Hessian in the offset (F, C, 3, 3), times the
        contact stiffness: the barrier's own n nᵀ term and kaolin's
        friction terms (stick, slip and the regularised near-zero slip, the
        normal force's change with d, and the chain through |v|)."""
        cfg = self.cfg
        _, nor, _, _, active, dp, dc, vt = self._terms(con, jac, du)
        mu, nu, dt, rc = (cfg["friction"], cfg["friction_fluid"], self.dt,
                          con["rc"])
        eps = 1e-4
        vn = vt.norm(dim=-1)
        barrier = 2.0 * torch.log(dp)
        de = -dc * (barrier + dc / dp)
        db = 2.0 / dp
        ddc = (dp - dc) / (dp * dp)
        d2e = -(barrier + dc / dp) - dc * (db + ddc)
        nn = nor[..., :, None] * nor[..., None, :]
        vv = vt[..., :, None] * vt[..., None, :]
        tangent = torch.eye(3, dtype=nor.dtype, device=nor.device) - nn

        mu_n = -mu * de / rc
        mu_n_d = -mu * d2e / rc
        f1 = torch.where(vn < 1.0, 2.0 - vn, 1.0 / torch.clamp(vn, min=1e-12))
        f1_nu = f1 + nu
        v_safe = torch.clamp(vn, min=eps)
        h = _col(d2e / (rc * rc)) * nn
        h_zero = _col(mu_n / dt * f1_nu) * tangent
        h_stick = _col(mu_n / dt) * (_col(f1_nu) * tangent
                                     - vv / _col(v_safe * dt))
        h_slip = _col(mu_n) * (_col(-1.0 / (v_safe * v_safe)
                                    / (v_safe * dt)) * vv
                               + _col(f1_nu / dt) * tangent)
        h = h + torch.where(_col(vn < eps), h_zero,
                            torch.where(_col(vn < 1.0), h_stick, h_slip))
        h = h + _col(mu_n_d * f1_nu / rc) * (vt[..., :, None]
                                             * nor[..., None, :])
        h_v = 0.5 * nu * vn ** 2 + torch.where(
            vn < 1.0, vn ** 2 * (1.0 - vn / 3.0), vn - 1.0 / 3.0)
        h_v_d = torch.where(vn < 1.0, nu * vn + 2.0 * vn - vn ** 2,
                            nu * vn + 1.0)
        d2b = -2.0 / (dp * dp)
        dddc = -2.0 * ddc / dp
        d3e = -(db - dc / (dp * dp)) - (d2b + dddc) * dc - (db + ddc)
        dvn = torch.where((vn > eps)[..., None],
                          vt / (v_safe * dt)[..., None], 0.0)
        h = h + _col(-mu * dt / (rc * rc)) * (
            _col(d2e * h_v_d) * (nor[..., :, None] * dvn[..., None, :])
            + _col(h_v * d3e / rc) * nn)
        return cfg["collision_penalty"] * torch.where(_col(active), h, 0.0)

    def _bounds(self, con, jac, du, direction):
        """kaolin's step bound of each raw (pre-QR) DOF, (F, D) in float64:
        the least over the contacts whose LBS row reaches it of the share
        of the step that closes at most 3/8 of the remaining gap to the
        barrier."""
        off, nor, _, _, _, _, _, _ = self._terms(con, jac, du)
        rows_a = self._rows(con["a"])
        rows_b = self._rows(con["b"], con["b_kin"])
        step = direction[:, None, :, None]
        dd_a = (nor * (rows_a @ step)[..., 0]).sum(-1)
        dd_b = -(nor * (rows_b @ step)[..., 0]).sum(-1)
        gap = self.cfg["impenetrable_barrier_ratio"] * con["rc"] \
            - (off * nor).sum(-1)
        ok = (gap < 0.0) & con["valid"]
        most = 0.5 * 0.75 * gap

        def tmax(dd):
            closing = (dd < 0.0) & ok
            t = torch.clamp(most / torch.where(closing, dd, -1.0), 0.0, 1.0)
            return torch.where(closing, t, 1.0).double()

        f = direction.shape[0]
        cols = self.raw_q.shape[1]
        bound = torch.ones((f, self.n_cubes, cols), dtype=torch.float64,
                           device=self.device)
        n_dyn = self.raw_q.shape[0]
        for side, t, kin in (("a", tmax(dd_a), None),
                             ("b", tmax(dd_b), con["b_kin"])):
            idx = con[side]
            live = con["valid"] if kin is None else con["valid"] & ~kin
            safe = torch.where(live, idx, 0).clamp(max=n_dyn - 1)
            q = self.raw_q[safe]
            reach = torch.where((q != 0.0) & live[..., None], t[..., None],
                                1.0)
            cube = self.obj[safe][..., None].expand(-1, -1, cols)
            bound.scatter_reduce_(1, cube, reach, "amin")
        # each raw DOF (h, r, s) takes its handle column (h, s)'s bound
        h = cols // 4
        return bound.reshape(f, self.n_cubes, h, 1, 4).expand(
            f, self.n_cubes, h, 3, 4).reshape(f, -1)

    # -- the step --
    def _hessian(self, x, con, jac, du):
        """H (F, D, D) at states x: M, dt² times the elastic and floor
        terms of each cube and kaolin's contact terms, and the
        regulariser."""
        cfg, dt, m = self.cfg, self.dt, self.mass
        f = x.shape[0]
        hess = torch.zeros((f,) + self.eye.shape, dtype=x.dtype,
                           device=x.device)
        defo = self._defo(x)
        pts = self.points(x)
        nc, dc = self.n_cube, self.cube_dofs
        neo = torch.vmap(torch.func.hessian(
            lambda f_: _neo_hookean(f_, self.mu, self.lam)))
        one_pt = torch.vmap(torch.func.hessian(self._one_point))
        for c, (b, fz) in enumerate(zip(self.b_blocks, self.f_blocks)):
            pts_c = slice(c * nc, (c + 1) * nc)
            hf = self.vol * neo(defo[:, pts_c].reshape(-1, 3, 3)).reshape(
                f, nc, 9, 9)
            h_el = fz.T @ (hf @ fz.reshape(nc, 9, dc)).reshape(f, 9 * nc, dc)
            hp = one_pt(pts[:, pts_c].reshape(-1, 3)).reshape(f, nc, 3, 3)
            h_pt = b.T @ (hp @ b.reshape(nc, 3, dc)).reshape(f, 3 * nc, dc)
            dofs = slice(c * dc, (c + 1) * dc)
            hess[:, dofs, dofs] = h_el + h_pt
        hc = self._contact_hessian(con, jac, du)
        cols = jac.shape[-1]
        h_c = jac.reshape(f, -1, cols).mT @ (hc @ jac).reshape(f, -1, cols)
        return (m * self.eye + dt * dt * (hess + h_c)
                + cfg["newton_hessian_regularizer"] * self.eye)

    def steps(self, u, v, con=None):
        """One implicit step of each frame from states u and velocities v
        (F, D) → (u, v) after; ``con``: the contacts at u, where
        :meth:`detect` has found them."""
        cfg, dt, m = self.cfg, self.dt, self.mass
        target = u + dt * v
        con = self.detect(u) if con is None else con
        jac = self.jacobian(con)

        def energy(x):
            d = x - target
            return (0.5 * m * (d * d).sum(-1) + dt * dt * (
                self.potential(x) + self.contact_energy(con, jac, x - u)))

        x = u
        moving = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
        for _ in range(cfg["max_newton_steps"]):
            g = torch.func.grad(lambda x_: energy(x_).sum())(x)
            dx = -_solve(self._hessian(x, con, jac, x - u), g)
            moving = moving & ~((dx * g).sum(-1).double().abs()
                                < cfg["conv_tol"])
            if not bool(moving.any()):
                break
            bounds = self._bounds(con, jac, x - u, dx)
            step = self._line_search(energy, x, dx, g, bounds, moving)
            x = torch.where(moving[:, None], x + step, x)
        return x, (x - u) / dt

    def _one_point(self, x):
        """One cube point's floor energy (its gravity is linear)."""
        h, axis, k = (self.cfg["floor_height"], self.cfg["floor_axis"],
                      self.cfg["floor_penalty"])
        below = x[axis] - h
        return k * torch.where(below < 0, below * below, 0.0)

    def _bounded(self, direction, bounds, t):
        """Each frame's step t·d clamped DOF by DOF in the raw basis by
        ``bounds``, in float64, back in the cubes' bases."""
        raw = direction.double() @ self.Rinv64.T
        return ((raw * torch.minimum(bounds, t[:, None])) @ self.R64.T).to(
            direction.dtype)

    def _line_search(self, energy, x, direction, gradient, bounds, moving):
        """kaolin's backtracking Armijo search under the step bounds, each
        frame its own → the accepted updates. From t = 1: a step that meets
        f(x + s) ≤ f(x) + α s·g is taken if an earlier one did, else t
        grows by 1/β; one that does not shrinks t by β; after
        ``max_ls_steps`` tries the step at the current t is taken. Frames
        not ``moving`` take none."""
        cfg = self.cfg
        alpha, beta = cfg["ls_alpha"], cfg["ls_beta"]
        f0 = energy(x)
        t = torch.ones(x.shape[0], dtype=torch.float64, device=x.device)
        can_break = torch.zeros_like(moving)
        done = ~moving
        out = torch.zeros_like(x)
        for _ in range(cfg["max_ls_steps"]):
            step = self._bounded(direction, bounds, t)
            ok = energy(x + step) <= f0 + alpha * (step * gradient).sum(-1)
            take = ok & can_break & ~done
            out = torch.where(take[:, None], step, out)
            done = done | take
            grow = ok & ~done
            t = torch.where(grow, t / beta, torch.where(done, t, t * beta))
            can_break = can_break | grow
            if bool(done.all()):
                return out
        last = self._bounded(direction, bounds, t)
        return torch.where(done[:, None], out, last)

    def step(self, u, v):
        """One implicit step from state u and velocity v (D,) → (u, v)
        after."""
        u1, v1 = self.steps(u[None], v[None])
        return u1[0], v1[0]

    # -- what the check compares --
    def total_energy(self, u, v):
        """Kinetic ½ vᵀMv, the cubes' elastic, gravity and floor energy, the
        plate's gravity, and the barrier of the pairs within detection
        reach at states u (F, D) → (F,) (its friction is 0 with no motion
        since detection)."""
        con = self.detect(u)
        jac = self.jacobian(con)
        zero = torch.zeros_like(u)
        return (0.5 * self.mass * (v * v).sum(-1) + self.potential(u)
                + self.plate_energy()
                + self.contact_energy(con, jac, zero))


def _solve(h, g):
    """H⁻¹g of each frame as kaolin takes it: Cholesky of the symmetric
    matrix of H's upper triangle, and LU where that fails or gives a
    non-finite solution."""
    low, info = torch.linalg.cholesky_ex(h.mT)
    dx = torch.cholesky_solve(g[..., None], low)[..., 0]
    bad = (info != 0) | ~torch.isfinite(dx).all(-1)
    if bool(bad.any()):
        lu = torch.linalg.solve_ex(h, g)[0]
        dx = torch.where(bad[:, None], lu, dx)
    return dx


def frames(stack_of, n_steps, episode_frames):
    """The first ``n_steps`` frames from rest, back at rest after every
    ``episode_frames`` frames, frame i stepped by the stack
    ``stack_of(i)`` → each frame's start (the cubes' displacement B u and
    velocity B v, float64), its cube points (6N, 3) after and the total
    energy there."""
    stack = stack_of(0)
    rest = stack.x0.new_zeros(stack.B.shape[1])
    u, v = rest, rest
    starts, pts, energy = [], [], []
    for i in range(n_steps):
        stack = stack_of(i)
        starts.append((stack.B64 @ u.double(), stack.B64 @ v.double()))
        u, v = stack.step(u, v)
        pts.append(stack.points(u))
        energy.append(stack.total_energy(u[None], v[None])[0])
        if (i + 1) % episode_frames == 0:
            u, v = rest, rest
    return starts, pts, energy


def steps_from(stack, starts, episode_frames):
    """One step from each of the frames' starts, a batch of ``CHUNK`` at a
    time. A start is the cubes' displacement and velocity (3·6N,) in any
    basis of their LBS space, whose coordinates in the reference's bases
    are the orthonormal projections, in float64; the start of every
    ``episode_frames``-th frame (0 included) is rest, where the traffic
    resets the scene, whatever was given → (the cube points after (F, 6N,
    3), the total energy there (F,), the starts' contacts: pairs between
    cubes and pairs with the plate (F, 2))."""
    pts, energy, pairs = [], [], []
    for c0 in range(0, len(starts), CHUNK):
        part = range(c0, min(c0 + CHUNK, len(starts)))
        disp = torch.stack([starts[i][0] for i in part]).double()
        vel = torch.stack([starts[i][1] for i in part]).double()
        reset = torch.tensor([i % episode_frames == 0 for i in part],
                             device=disp.device)[:, None]
        u = torch.where(reset, 0.0, disp @ stack.B64).to(stack.dtype)
        v = torch.where(reset, 0.0, vel @ stack.B64).to(stack.dtype)
        con = stack.detect(u)
        plate = (con["b_kin"] & con["valid"]).sum(-1)
        pairs.append(torch.stack([con["valid"].sum(-1) - plate, plate], -1))
        u1, v1 = stack.steps(u, v, con)
        pts.append(stack.points(u1))
        energy.append(stack.total_energy(u1, v1))
    return torch.cat(pts), torch.cat(energy), torch.cat(pairs)
