"""Simplicits scene simulation: reduced-order implicit elastodynamics, in
PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/simulation.py``. B (3N ×
12H), dF/dz (9N × 12H) and BMB are dense; a sim step assembles energy,
gradient and Hessian from them, runs Newton with the batched Armijo line
search of :mod:`kaolin_tpu_torch.physics.common.optimization` and updates
the velocity. The step is plain PyTorch (the JAX package has no Pallas
kernel here): dense products through ``torch.matmul``/``bmm``, solves
through ``torch.linalg``.

A scene runs on the CUDA device unless it is given ``device="cpu"``; with
no CUDA device and no ``device`` it raises. ``use_cuda_graphs=True``
captures the step (Cholesky solves only) in ``torch.cuda.CUDAGraph``s over
static state buffers: the set-up and two Newton iterations, one more
iteration, and the state's update. Each step replays the first, the second
while the device's convergence flag, read by the host, is not set, and the
last, so it runs the early-exit loop's iterations; a step whose Cholesky
failed runs again eagerly, with the LU fallback. With contact the Cholesky
fails often (friction makes the Hessian not symmetric), so that step is
a graph of detection and a graph of Newton's fixed trip, which solves by
LU beside every Cholesky and takes it where the Cholesky failed, as the
eager step does.

Contact (:meth:`SimplicitsScene.enable_collisions`,
:mod:`kaolin_tpu_torch.physics.common.collisions`) runs inside the step:
detection once at its start, the contact energy, gradient and Hessian in
the assembly, the contact bounds in the line search. Detection reads nothing
back to the host, so a graph captures it too. The contact terms are taken
in z's own basis where the float32 QR rotation would lose them
(``CONTACT_ROUNDING_LIMIT``), else in the raw basis and rotated. Each step
ORs its capacity overflow bits into a flag on the device
(:meth:`SimplicitsScene.collision_overflow_flags`); the host reads it every
``collision_resize_interval`` steps and after ``run_sim_steps``, and on an
overflow re-measures the capacities and builds the step (and graphs) anew.

Spans (:mod:`kaolin_tpu_torch.utils.profiling`, while ``torch.profiler``
runs): ``physics.simplicits.step`` around :meth:`SimplicitsScene.run_sim_step`
and :meth:`~SimplicitsScene.run_sim_steps`; inside it
``physics.simplicits.capture`` (the graphs' capture),
``physics.simplicits.replay`` (a step's replays and flag reads, or the
read of the LU count after the replays), inside it
``physics.simplicits.iterate`` (a replay of one more iteration and its
read), ``physics.simplicits.rerun`` (a step whose Cholesky failed, run
again eagerly) and ``physics.simplicits.detect`` (contact detection: the
replay of its graph, or detection in an eager step or a capture);
``physics.newton.*`` inside each eager step and capture; and
``physics.simplicits.deformed_pts`` around
:meth:`~SimplicitsScene.get_object_deformed_pts`. Host counters, always on:
``CAPTURES``, ``GRAPH_REPLAYS`` (one a step) and ``NEWTON_ITERATIONS`` (the
iterations the graphs ran: ``max_newton_steps`` a replay of the fixed
trip); a scene counts its own reruns and LU steps (``graph_steps_rerun``,
``graph_steps_lu``). A device counter, while the profiler runs:
``CONTACTS``, the live pairs each step's detection found.
"""

import warnings

import numpy as np
import torch

from kaolin_tpu_torch.physics.common.collisions import Collision
from kaolin_tpu_torch.physics.common.optimization import (
    cholesky_only,
    newton_iteration,
    newtons_method,
)
from kaolin_tpu_torch.physics.common.scene_forces import (
    Boundary,
    Floor,
    Gravity,
)
from kaolin_tpu_torch.physics.materials.material_utils import to_lame
from kaolin_tpu_torch.physics.materials.neohookean_elastic_material import (
    NeohookeanElasticMaterial,
)
from kaolin_tpu_torch.physics.simplicits.precomputed import (
    dFdz_matrix,
    lbs_matrix,
)
from kaolin_tpu_torch.physics.simplicits.skinning import standard_lbs
from kaolin_tpu_torch.physics.simplicits.training import (
    SimplicitsObject,
    SkinnedPhysicsPoints,
    SkinnedPoints,
    _tensor,
)
from kaolin_tpu_torch.physics.utils.torch_utilities import (
    hess_reduction,
    standard_transform_to_relative,
)
from kaolin_tpu_torch.utils import profiling
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["SimulatedObject", "SimplicitsScene"]

# the largest ε cond(B) at which the QR re-basis is made in B's own
# precision (see SimulatedObject._apply_qr_decomposition)
QR_ROUNDING_LIMIT = 1e-2

# the Newton iterations the graph without the LU runs before its first
# read of the convergence flag: every step that moves runs two
START_ITERATIONS = 2

# the largest ε₃₂ cond(B)² over a scene's dynamic QR objects at which
# contact terms are taken in the raw basis and turned into z's by the
# float32 QR rotation (see SimplicitsScene.enable_collisions)
CONTACT_ROUNDING_LIMIT = 0.1

CAPTURES = "physics.simplicits.captures"
GRAPH_REPLAYS = "physics.simplicits.graph_replays"
NEWTON_ITERATIONS = "physics.simplicits.newton_iterations"
for _name in (CAPTURES, GRAPH_REPLAYS, NEWTON_ITERATIONS):
    profiling.count(_name, 0)
DETECT_SPAN = "physics.simplicits.detect"
# a device counter: the live contact pairs the steps detected
CONTACTS = "physics.collision.contacts"


def _count_contacts(live):
    """Add a detection's live pairs (0-dim int64 on the device) to
    ``CONTACTS`` while the profiler runs."""
    counter = profiling.device_counter(CONTACTS, live.device)
    if counter is not None:
        counter.add_(live)


class SimulatedObject(SkinnedPhysicsPoints):
    """Per-object simulation state and dense LBS operators, on ``device``
    (None: where ``pts`` lies)."""

    def __init__(self, pts, yms, prs, rhos, appx_vol, skinning_weights, dwdx,
                 renderable=None, init_transform=None, is_kinematic=False,
                 normalize_weights_by_samples=False, apply_qr=False,
                 num_real_qp=None, device=None):
        pts = _tensor(pts)
        device = pts.device if device is None else torch.device(device)

        def on(x):
            return None if x is None else _tensor(x).to(device)

        skinning_weights, dwdx = on(skinning_weights), on(dwdx)
        handle_norms = None
        if normalize_weights_by_samples:
            # in float64, rounded once: every device gets the same norms,
            # and the pivoted QR below the same pivots (the same z basis)
            handle_norms = torch.clamp(torch.linalg.norm(
                skinning_weights.double(), dim=0).to(skinning_weights.dtype),
                min=1e-10)
            skinning_weights = skinning_weights / handle_norms[None, :]
            dwdx = dwdx / handle_norms.reshape(1, -1, 1)
        if renderable is not None:
            renderable = SkinnedPoints(on(renderable.pts),
                                       on(renderable.skinning_weights))
        super().__init__(pts.to(device), on(yms), on(prs), on(rhos), appx_vol,
                         skinning_weights, dwdx, renderable=renderable,
                         num_real_qp=num_real_qp)
        self.handle_norms = handle_norms
        self.init_transform = on(init_transform)
        self.is_kinematic = is_kinematic
        self.normalize_weights_by_samples = normalize_weights_by_samples
        self.apply_qr = apply_qr

        self.num_qp = self.pts.shape[0]
        # padding points carry zero volume and mass: the quadrature rule
        # integrates over the real sample count only
        n_real = self.num_qp if num_real_qp is None else int(num_real_qp)
        is_real = torch.arange(self.num_qp, device=device) < n_real
        self.sample_vols = torch.where(is_real, self.appx_vol / n_real,
                                       0.0).to(self.dtype)
        self.sample_masses = torch.where(
            is_real, (self.appx_vol / n_real) * self.rhos, 0.0).to(self.dtype)

        self.B_dense = lbs_matrix(self.pts, self.skinning_weights)
        if is_kinematic:
            self.dFdz_dense = self.pts.new_zeros(
                (9 * self.num_qp, 12 * self.num_handles))
        else:
            self.dFdz_dense = dFdz_matrix(self.skinning_weights, self.dwdx,
                                          self.pts)

        self.qr_tfm = None
        self.qr_tfm_inv = None
        self.qr_tfm64 = None
        # the contact terms' per-point factors in z's own basis, set where
        # the scene takes them there (SimplicitsScene.enable_collisions)
        self.contact_factors = None
        if apply_qr:
            self._apply_qr_decomposition()

        self.z = None
        self.z_prev = None
        self.z_dot = None
        self.reset_sim_state()

    def _apply_qr_decomposition(self):
        """Column-pivoted economic QR of B for conditioning, on the host
        with scipy (set-up only): B Π = Q R, K = Π R⁻¹, so B K = Q and
        dFdz becomes dFdz K. ``qr_tfm64`` keeps K in float64 for the
        readouts (:meth:`SimplicitsScene._get_object_transforms_internal`).

        The QR of B as it is (float32) gives K to about ε cond(B), which
        the ratio of R's first and last diagonal entries estimates. Past
        ``QR_ROUNDING_LIMIT`` the QR is made again from B and dF/dz built
        in float64 from the points and weights, and the products are
        rounded once, after K: smooth weights can leave B's columns nearly
        dependent (32 sin weights and the constant one at 1,000 points:
        cond(B) ~ 2e8, K's entries ~ 5e7), and a float32 QR there gives a
        B K far from orthonormal (|(BK)ᵀBK − I| up to 4) and a dF/dz K that
        is not B K's derivative, so the step's motion leaves the skinning
        space."""
        from scipy.linalg import qr, solve_triangular

        def rotation(b):
            _, r, p = qr(b, mode="economic", pivoting=True)
            pmat = np.eye(b.shape[1], dtype=b.dtype)[:, p]
            rinv = solve_triangular(r, np.eye(r.shape[0], dtype=r.dtype))
            return np.abs(np.diag(r)), pmat @ rinv, r @ pmat.T

        dtype, device = self.B_dense.dtype, self.B_dense.device
        np_b = self.B_dense.cpu().numpy()
        diag, tfm, tfm_inv = rotation(np_b)
        eps = np.finfo(np_b.dtype).eps
        if eps * diag[0] <= QR_ROUNDING_LIMIT * diag[-1]:
            self.qr_tfm = torch.from_numpy(tfm).to(device)
            self.qr_tfm_inv = torch.from_numpy(tfm_inv).to(device)
            self.qr_tfm64 = self.qr_tfm.double()
            self.B_dense = self.B_dense @ self.qr_tfm
            if not self.is_kinematic:
                self.dFdz_dense = self.dFdz_dense @ self.qr_tfm
            return
        pts, w = self.pts.cpu().double(), self.skinning_weights.cpu().double()
        np_b = lbs_matrix(pts, w).numpy()
        _, tfm, tfm_inv = rotation(np_b)

        def rounded(m):
            return torch.from_numpy(m).to(device=device, dtype=dtype)

        self.qr_tfm = rounded(tfm)
        self.qr_tfm_inv = rounded(tfm_inv)
        self.qr_tfm64 = torch.from_numpy(tfm).to(device)
        self.B_dense = rounded(np_b @ tfm)
        if not self.is_kinematic:
            dfdz = dFdz_matrix(w, self.dwdx.cpu().double(), pts).numpy()
            self.dFdz_dense = rounded(dfdz @ tfm)

    def _lbs_factors64(self):
        """A = w ⊗ [x; 1] (N, 4H) in float64, on the host: row i holds
        w_ih [x_i; 1]_s at column 4h + s, so that B = A ⊗ I₃ in B's own
        column order 12h + 4r + s."""
        pts = self.pts.cpu().double()
        w = self.skinning_weights.cpu().double()
        hom = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
        return (w[:, :, None] * hom[:, None, :]).reshape(pts.shape[0], -1)

    def contact_rounding(self):
        """ε₃₂ cond(B)² over the real points and the handles that reach
        them (padding adds neither), by R's diagonal ratio of a pivoted
        float64 QR of their A: about the relative error of the
        contact terms taken in the raw (pre-QR) basis in float32 and
        turned into z's basis by the QR rotation K, which carries their
        rounding, of the size of the raw terms, through both of its
        factors."""
        from scipy.linalg import qr

        n = self.num_qp if self.num_real_qp is None else int(
            self.num_real_qp)
        a = self._lbs_factors64()[:n]
        r = qr(a[:, a.abs().amax(0) > 0].numpy(), mode="r",
               pivoting=True)[0]
        diag = np.abs(np.diag(r))
        return float(np.finfo(np.float32).eps) * (diag[0] / diag[-1]) ** 2

    def _apply_contact_basis(self):
        """Re-base z by K = I₃ ⊗ K₄ from a pivoted float64 QR of A = w ⊗
        [x; 1] (A Π = Q R, K₄ = Π R⁻¹), so that B K = (A K₄) ⊗ I₃ keeps
        B's Kronecker form: a contact's rows in z's basis are then the
        factors A K₄ of its point (``contact_factors``, (N, 4H), made in
        float64 and rounded once), and the contact terms are taken in z's
        basis as they are in the raw one, with no float32 product with K.
        B K and dF/dz K are made in float64 and rounded once, as past
        ``QR_ROUNDING_LIMIT``. → the float64 (12H, 12H) map of the old z
        basis to the new one."""
        from scipy.linalg import qr, solve_triangular

        dtype, device = self.B_dense.dtype, self.B_dense.device
        a = self._lbs_factors64().numpy()
        _, r, p = qr(a, mode="economic", pivoting=True)
        pmat = np.eye(a.shape[1])[:, p]
        k4 = pmat @ solve_triangular(r, np.eye(r.shape[0]))
        k4_inv = r @ pmat.T

        def kron3(m):
            h = m.shape[0] // 4
            out = np.zeros((h, 3, 4, h, 3, 4))
            for rr in range(3):
                out[:, rr, :, :, rr, :] = m.reshape(h, 4, h, 4)
            return out.reshape(12 * h, 12 * h)

        def rounded(m):
            return torch.from_numpy(m).to(device=device, dtype=dtype)

        k = kron3(k4)
        old = (self.qr_tfm64.cpu().numpy() if self.qr_tfm64 is not None
               else np.eye(k.shape[0]))
        pts, w = self.pts.cpu().double(), self.skinning_weights.cpu().double()
        self.qr_tfm = rounded(k)
        self.qr_tfm_inv = rounded(kron3(k4_inv))
        self.qr_tfm64 = torch.from_numpy(k).to(device)
        self.B_dense = rounded(lbs_matrix(pts, w).numpy() @ k)
        if not self.is_kinematic:
            dfdz = dFdz_matrix(w, self.dwdx.cpu().double(), pts).numpy()
            self.dFdz_dense = rounded(dfdz @ k)
        self.contact_factors = rounded(a @ k4)
        return torch.from_numpy(kron3(k4_inv) @ old)

    @classmethod
    def from_skinned_physics_points(cls, phys_pts, init_transform,
                                    is_kinematic=False,
                                    normalize_weights_by_samples=False,
                                    apply_qr=False, device=None):
        return cls(pts=phys_pts.pts, yms=phys_pts.yms, prs=phys_pts.prs,
                   rhos=phys_pts.rhos, appx_vol=phys_pts.appx_vol,
                   skinning_weights=phys_pts.skinning_weights,
                   dwdx=phys_pts.dwdx, renderable=phys_pts.renderable,
                   init_transform=init_transform, is_kinematic=is_kinematic,
                   normalize_weights_by_samples=normalize_weights_by_samples,
                   apply_qr=apply_qr,
                   num_real_qp=getattr(phys_pts, "num_real_qp", None),
                   device=device)

    def reset_sim_state(self):
        """Handle transforms back to the initial deformation. The constant
        (last) handle weighs 1 everywhere, so the initial transform goes
        there."""
        z = self.pts.new_zeros((self.num_handles * 12,))
        if self.init_transform is not None:
            scale = (self.handle_norms[-1]
                     if self.normalize_weights_by_samples else 1.0)
            z[-12:] = self.init_transform.reshape(-1) * scale
            if self.apply_qr:
                z = self.qr_tfm_inv @ z
        self.z = z
        self.z_prev = z
        self.z_dot = torch.zeros_like(z)


class SimplicitsScene:
    """Scene assembly and implicit time stepping.

    ``device``: where the scene runs; None means the CUDA device, and raises
    without one. ``use_cuda_graphs``: capture a step in CUDA graphs and
    replay them (CUDA only); they run the early-exit loop's Newton
    iterations and give its z bit for bit, with one host read after the
    first two iterations and one after each later one; with contact,
    Newton's fixed trip, with one read a :meth:`run_sim_steps` call (see
    :meth:`_capture`).
    ``differentiable``: Newton's fixed trip on the eager path, so that
    the step of :meth:`build_functional_step` is differentiable by
    ``torch.autograd`` with respect to z, z_prev and z_dot (through the
    solves, the line search's choice and the energies). It cannot go with
    ``use_cuda_graphs``, whose replays run under ``torch.no_grad``: the two
    together raise."""

    def __init__(self, direct_solve=True, timestep=0.03, max_newton_steps=5,
                 max_ls_steps=10, newton_hessian_regularizer=1e-4,
                 cg_tol=1e-4, cg_iters=100, conv_tol=1e-4, device=None,
                 use_cuda_graphs=False, differentiable=False):
        if use_cuda_graphs and differentiable:
            raise ValueError("differentiable=True needs the eager step: a "
                             "CUDA graph replays under torch.no_grad")
        self.device = resolve_device(device, "SimplicitsScene")
        if use_cuda_graphs and self.device.type != "cuda":
            raise ValueError("use_cuda_graphs needs a CUDA device, got "
                             f"{self.device}")
        self.use_cuda_graphs = bool(use_cuda_graphs)
        self.dtype = torch.float32
        self.direct_solve = direct_solve
        self.differentiable = bool(differentiable)
        self.timestep = float(timestep)
        self.current_sim_step = 0
        self.max_newton_steps = int(max_newton_steps)
        self.max_ls_steps = int(max_ls_steps)
        self.newton_hessian_regularizer = float(newton_hessian_regularizer)
        self.cg_tol = float(cg_tol)
        self.cg_iters = int(cg_iters)
        self.conv_tol = float(conv_tol)

        self.current_id = 0
        self.sim_obj_dict = {}
        self.force_dict = {"pt_wise": {}, "defo_grad_wise": {}}
        self._ready_for_forces = False
        self._invalidate()
        self.graph_steps_rerun = 0
        self.graph_steps_lu = 0

        self.sim_z = None
        self.sim_z_prev = None
        self.sim_z_dot = None

        # contact capacity: each step ORs its overflow bits into
        # _col_overflow on the device; every collision_resize_interval steps
        # (and after run_sim_steps) the host reads it and, when set,
        # re-measures the capacities from the current configuration
        self.collision_auto_resize = True
        self.collision_resize_interval = 16
        self.collision_resizes = 0
        self._col_overflow = None
        self._sim_B_raw = None

    def _invalidate(self):
        """Forget the built step and graph: the forces or the contact
        capacities changed. The graph goes first, with the buffers and
        constants it holds."""
        self._graph = None
        self._step_fn = None

    # ---- objects ----
    def add_object(self, sim_object, num_qp=None, init_transform=None,
                   is_kinematic=False, renderable_pts=None,
                   normalize_weights_by_samples=True, apply_qr=True):
        """Add a SimplicitsObject (baked here at ``num_qp`` points) or
        SkinnedPhysicsPoints → the object's id."""
        if self._ready_for_forces:
            raise RuntimeError("Cannot add object after a force is set")
        if init_transform is not None:
            relative = standard_transform_to_relative(init_transform)
        else:
            relative = torch.zeros((3, 4), dtype=self.dtype)

        if isinstance(sim_object, SimplicitsObject):
            if num_qp is None:
                raise ValueError("'num_qp' required with SimplicitsObject")
            baked = sim_object.bake(num_qps=num_qp,
                                    renderable_pts=renderable_pts)
        else:
            if renderable_pts is not None:
                raise ValueError("renderable_pts needs a SimplicitsObject")
            baked = (sim_object.subsample(num_pts=num_qp)
                     if num_qp is not None else sim_object)
        obj = SimulatedObject.from_skinned_physics_points(
            baked, init_transform=relative, is_kinematic=is_kinematic,
            normalize_weights_by_samples=normalize_weights_by_samples,
            apply_qr=apply_qr, device=self.device)
        self.sim_obj_dict[self.current_id] = obj
        self.current_id += 1
        return self.current_id - 1

    def get_object(self, obj_idx):
        return self.sim_obj_dict[obj_idx]

    # ---- scene constants ----
    def _compute_sim_constants(self):
        """Stack the objects' operators into block-diagonal scene
        operators."""
        objs = list(self.sim_obj_dict.values())
        if not objs:
            raise RuntimeError("scene has no objects")
        self.num_objects = len(objs)

        self.obj_qp_slices = []
        self.obj_z_slices = []
        qp0, z0 = 0, 0
        kin_dofs = []
        qp_is_kin = []
        qp_obj_ids = []
        for oid, obj in self.sim_obj_dict.items():
            self.obj_qp_slices.append(slice(qp0, qp0 + obj.num_qp))
            self.obj_z_slices.append(slice(z0, z0 + 12 * obj.num_handles))
            if obj.is_kinematic:
                kin_dofs.extend(range(z0, z0 + 12 * obj.num_handles))
            qp_is_kin.append(np.full(obj.num_qp, int(obj.is_kinematic)))
            qp_obj_ids.append(np.full(obj.num_qp, oid))
            qp0 += obj.num_qp
            z0 += 12 * obj.num_handles
        self.total_qp = qp0
        self.total_dofs = z0
        self.qp_is_kinematic = torch.from_numpy(
            np.concatenate(qp_is_kin).astype(np.int32)).to(self.device)
        self.qp_to_object_map = torch.from_numpy(
            np.concatenate(qp_obj_ids).astype(np.int32)).to(self.device)
        # phantom points (the padding of a heterogeneous batch) are left
        # out of contact altogether: they are not physical and sit far
        # outside the content's box
        self._qp_is_real = np.concatenate([
            np.arange(o.num_qp) < (o.num_qp if o.num_real_qp is None
                                   else int(o.num_real_qp)) for o in objs])
        self.qp_is_phantom = torch.from_numpy(~self._qp_is_real).to(
            self.device)
        mask = np.ones(z0, dtype=bool)
        mask[kin_dofs] = False
        self.dyn_idx = np.nonzero(mask)[0]

        self.sim_pts = torch.cat([o.pts for o in objs])
        self.sim_rhos = torch.cat([o.rhos for o in objs])
        self.sim_vols = torch.cat([o.sample_vols for o in objs])
        self.sim_masses = torch.cat([o.sample_masses for o in objs])
        self.sim_mus, self.sim_lams = to_lame(
            torch.cat([o.yms for o in objs]), torch.cat([o.prs for o in objs]))

        self.sim_B = torch.block_diag(*(o.B_dense for o in objs))
        self.sim_dFdz = torch.block_diag(*(o.dFdz_dense for o in objs))
        m_diag = torch.repeat_interleave(self.sim_masses, 3)
        self.sim_BMB = self.sim_B.T @ (m_diag[:, None] * self.sim_B)

        self.sim_qr_tfm = None
        self.sim_qr_tfm_red = None
        self.sim_qr_tfm_inv_red = None
        if any(o.apply_qr for o in objs):
            def eye(o):
                return torch.eye(12 * o.num_handles, dtype=self.dtype,
                                 device=self.device)

            tfs = [o.qr_tfm if o.apply_qr else eye(o) for o in objs]
            tfis = [o.qr_tfm_inv if o.apply_qr else eye(o) for o in objs]
            self.sim_qr_tfm = torch.block_diag(*tfs)
            dyn = [i for i, o in enumerate(objs) if not o.is_kinematic]
            if dyn:
                self.sim_qr_tfm_red = torch.block_diag(*(tfs[i] for i in dyn))
                self.sim_qr_tfm_inv_red = torch.block_diag(
                    *(tfis[i] for i in dyn))

        elastic = NeohookeanElasticMaterial(
            mu=self.sim_mus, lam=self.sim_lams,
            integration_pt_volume=self.sim_vols, reparameterize_lame=True)
        self.force_dict["defo_grad_wise"]["material"] = {
            "object": elastic, "coeff": 1.0}

    def _get_scene_ready_for_forces(self):
        if not self.sim_obj_dict:
            raise RuntimeError("scene has no objects to apply forces on")
        self._compute_sim_constants()
        self.reset_scene()
        self._ready_for_forces = True

    @property
    def sim_B_raw(self):
        """The raw (pre-QR) LBS rows, (3N, D), made on first use: the step
        uses the per-particle factors (w, [x;1]) instead; this is for tests
        and tools that want the explicit operator."""
        if self._sim_B_raw is None:
            self._sim_B_raw = torch.block_diag(*(
                lbs_matrix(o.pts, o.skinning_weights)
                for o in self.sim_obj_dict.values()))
        return self._sim_B_raw

    # ---- forces ----
    def set_scene_gravity(self, acc_gravity=(0.0, 9.8, 0.0),
                          gravity_coeff=1.0):
        if not self._ready_for_forces:
            self._get_scene_ready_for_forces()
        g = torch.as_tensor(acc_gravity, dtype=self.dtype).to(self.device)
        self.force_dict["pt_wise"]["gravity"] = {
            "object": Gravity(g, self.sim_rhos, self.sim_vols),
            "coeff": float(gravity_coeff)}
        self._invalidate()

    def set_scene_floor(self, floor_height=0.0, floor_axis=1,
                        floor_penalty=10000.0, flip_floor=False):
        if not self._ready_for_forces:
            self._get_scene_ready_for_forces()
        self.force_dict["pt_wise"]["floor"] = {
            "object": Floor(floor_height, floor_axis, flip_floor,
                            torch.ones_like(self.sim_vols)),
            "coeff": float(floor_penalty)}
        self._invalidate()

    def set_object_boundary_condition(self, obj_idx, name, fcn,
                                      bdry_penalty=10000.0, pinned_x=None):
        """Pin the points of an object that ``fcn(pts) → bool mask``
        selects, at their current positions or at ``pinned_x``."""
        if not self._ready_for_forces:
            self._get_scene_ready_for_forces()
        boundary = Boundary(self.sim_vols)
        sl = self.obj_qp_slices[obj_idx]
        deformed = self.get_object_deformed_pts(obj_idx, points="simulated")
        sel = torch.nonzero(torch.as_tensor(fcn(deformed),
                                            device=self.device))[:, 0]
        if pinned_x is None:
            pinned_x = deformed[sel]
        boundary.set_pinned(sel + sl.start, pinned_x)
        self.force_dict["pt_wise"][name] = {
            "object": boundary, "coeff": float(bdry_penalty)}
        self._invalidate()
        return pinned_x

    # contact particles from which the grid broad phase is the default
    GRID_BROAD_PHASE_THRESHOLD = 2048

    def enable_collisions(self, collision_particle_radius=0.1,
                          detection_ratio=1.5, impenetrable_barrier_ratio=0.25,
                          collision_penalty=1000.0, max_contact_pairs=10000,
                          friction=0.5, broad_phase=None, cell_capacity=None,
                          sweep_window=None, slot_contact_capacity=None,
                          max_occupied_cells=None):
        """Particle contact between the scene's points.

        ``broad_phase``: ``"dense"`` (the exact N² pair matrix), ``"grid"``
        (the occupied-cell grid), ``"sweep"`` (sort and window along the
        longest axis), or None: the grid from ``GRID_BROAD_PHASE_THRESHOLD``
        contact particles, and then the dense matrix where N² is below the
        grid's M·14·K² tests; below the threshold the dense matrix.
        ``cell_capacity`` (K) and ``max_occupied_cells`` (M) default to sizes
        measured at rest with headroom, the sweep window to
        :meth:`_auto_sweep_window`. ``slot_contact_capacity`` is accepted and
        unused, as in the JAX package. Overflow in a step is reported
        (:meth:`collision_diagnostics`) and resized
        (:meth:`check_collision_capacity`)."""
        if not self._ready_for_forces:
            self._get_scene_ready_for_forces()
        auto_broad = broad_phase is None
        if broad_phase is None:
            broad_phase = ("grid" if self.total_qp >=
                           self.GRID_BROAD_PHASE_THRESHOLD else "dense")
        if broad_phase == "sweep" and sweep_window is None:
            sweep_window = self._auto_sweep_window(
                collision_particle_radius, detection_ratio)
        collision = Collision(
            dt=self.timestep,
            collision_particle_radius=collision_particle_radius,
            detection_ratio=detection_ratio,
            impenetrable_barrier_ratio=impenetrable_barrier_ratio,
            collision_penalty_stiffness=collision_penalty,
            friction_regularization=0.1, friction_fluid=0.1,
            friction=friction,
            max_contacting_pairs=min(max_contact_pairs,
                                     self.total_qp * (self.total_qp - 1) // 2),
            bounds=True, broad_phase=broad_phase,
            cell_capacity=16 if cell_capacity is None else cell_capacity,
            sweep_window=128 if sweep_window is None else sweep_window,
            max_occupied_cells=(2048 if max_occupied_cells is None
                                else max_occupied_cells))
        if broad_phase == "grid":
            # sized from the real points only: phantom points would blow
            # the grid's span; in a step they clamp into boundary cells,
            # and the exclusion mask drops them
            real = self._qp_is_real
            collision.configure_grid(
                self.sim_pts.cpu().numpy()[real],
                obj_ids=self.qp_to_object_map.cpu().numpy()[real],
                headroom_k=1.25,
                auto_capacities=(cell_capacity is None
                                 or max_occupied_cells is None))
            if cell_capacity is not None:
                collision.cell_capacity = int(cell_capacity)
            if max_occupied_cells is not None:
                collision.max_occupied_cells = int(max_occupied_cells)
            if auto_broad:
                # cells cannot shrink below the detection radius: a cloud
                # packed tighter than it makes K large, and then the N²
                # matrix takes fewer tests
                grid_tests = (collision.max_occupied_cells * 14
                              * collision.cell_capacity ** 2)
                n_real = int(real.sum())
                if n_real * n_real < grid_tests:
                    collision.broad_phase = "dense"
        self.force_dict["collision"] = {"object": collision,
                                        "coeff": float(collision_penalty)}
        self._rebase_for_contact()
        self._invalidate()

    def _rebase_for_contact(self):
        """Take the contact terms in z's own basis where the float32 QR
        rotation would lose them: where some dynamic object with the QR has
        ε₃₂ cond(B)² over ``CONTACT_ROUNDING_LIMIT``
        (:meth:`SimulatedObject.contact_rounding`), every object with the
        QR is re-based by :meth:`SimulatedObject._apply_contact_basis` and
        the scene's state carried into the new bases. A contact row is
        then its point's factors in z's basis, so the offsets, the
        gradient's pull-back, the reduced Hessian and the step bounds are
        taken with no product with K (whose entries reach 1e6 where B's
        columns are nearly dependent). The step bounds of a DOF are then
        the least of its object's contacts', as kaolin's per-handle bounds
        in the raw basis are wherever no weight or rest coordinate is
        exactly 0, and they clamp in z's basis. Scenes under the limit keep
        the raw basis and the rotation, as the JAX package takes them."""
        objs = list(self.sim_obj_dict.values())
        if self._contact_in_z() or not any(
                o.apply_qr and not o.is_kinematic
                and o.contact_rounding() > CONTACT_ROUNDING_LIMIT
                for o in objs):
            return
        maps = {i: o._apply_contact_basis() for i, o in enumerate(objs)
                if o.apply_qr}
        for i in maps:
            objs[i].reset_sim_state()
        state = [getattr(self, k) for k in ("sim_z", "sim_z_prev",
                                            "sim_z_dot")]
        self._compute_sim_constants()
        for k, v in zip(("sim_z", "sim_z_prev", "sim_z_dot"), state):
            v = v.clone()
            for i, m in maps.items():
                sl = self.obj_z_slices[i]
                v[sl] = (m.to(v.device) @ v[sl].double()).to(v.dtype)
            setattr(self, k, v)

    def _collision_provably_empty(self):
        """True when the collision force can never make a contact, so the
        step leaves detection out with the same result: one object (the
        narrow phase ignores same-object pairs whose squared rest distance
        is under ``collision_radius * ignore_self_collision_ratio``, and
        rest distances never change) whose rest box diagonal² is under that
        bound."""
        if "collision" not in self.force_dict:
            return True
        col = self.force_dict["collision"]["object"]
        ids = self.qp_to_object_map.cpu().numpy()[self._qp_is_real]
        if np.unique(ids).size > 1:
            return False
        pts = self.sim_pts.cpu().numpy()
        diag2 = float(((pts.max(0) - pts.min(0)) ** 2).sum())
        return diag2 < col.collision_radius * col.ignore_self_collision_ratio

    def _auto_sweep_window(self, collision_particle_radius, detection_ratio,
                           margin=1.5, minimum=64):
        """The sweep window from the rest configuration: the most points in
        any point's detection slab along the longest axis, with headroom,
        rounded up to a power of two."""
        pts = self.sim_pts.cpu().numpy()
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        key = np.sort(pts[:, axis])
        radius = 2.0 * collision_particle_radius * detection_ratio
        load = np.searchsorted(key, key + radius, side="right") \
            - np.arange(key.shape[0]) - 1
        want = int(load.max() * margin) + 8
        return int(min(max(minimum, 1 << int(np.ceil(np.log2(max(want, 1))))),
                       self.total_qp))

    def _phantoms(self):
        """The (N,) bool phantom mask for detection, or None when every
        point is real."""
        return None if self._qp_is_real.all() else self.qp_is_phantom

    def collision_diagnostics(self):
        """The collision force's :meth:`Collision.detection_diagnostics` at
        the scene's current state."""
        if "collision" not in self.force_dict:
            raise RuntimeError("collisions are not enabled on this scene")
        col = self.force_dict["collision"]["object"]
        with torch.no_grad():
            dx = (self.sim_B @ self.sim_z).reshape(-1, 3)
            return col.detection_diagnostics(
                dx, self.sim_pts, self.qp_to_object_map, self.qp_is_kinematic,
                cp_exclude=self._phantoms())

    # ---- state ----
    def reset_scene(self):
        """Every object back to its initial transform, at rest. With
        contact the overflow bits the steps ORed on the device stay for
        the next :meth:`check_collision_capacity`: an episode may end
        between two checks, and the bits of its last steps would be lost
        (without contact there are none, and nothing is read)."""
        self.current_sim_step = 0
        for obj in self.sim_obj_dict.values():
            obj.reset_sim_state()
        self.sim_z = torch.cat([o.z for o in self.sim_obj_dict.values()])
        self.sim_z_prev = torch.zeros_like(self.sim_z)
        self.sim_z_dot = torch.zeros_like(self.sim_z)
        if "collision" not in self.force_dict:
            self._col_overflow = None

    def collision_overflow_flags(self):
        """The contact-overflow bitmask the steps ORed on the device since
        the last capacity check (:meth:`check_collision_capacity`), as the
        device's 0-dim int32 tensor, not read back: 0 while every contact
        fitted (:meth:`Collision.diag_flags` gives its bits)."""
        return self._flags()

    def set_object_initial_transform(self, object_id, init_transform):
        if self.current_sim_step > 0:
            raise ValueError("cannot set initial transform mid-simulation")
        obj = self.sim_obj_dict[object_id]
        if obj.is_kinematic:
            raise ValueError("use set_kinematic_object_transform for "
                             "kinematic objects")
        obj.init_transform = standard_transform_to_relative(
            init_transform).to(self.device)
        self.reset_scene()

    def set_kinematic_object_transform(self, obj_idx, transform):
        """Script a kinematic object's motion mid-simulation."""
        obj = self.sim_obj_dict[obj_idx]
        if not obj.is_kinematic:
            raise ValueError("object is not kinematic")
        obj.init_transform = standard_transform_to_relative(transform).to(
            self.device)
        obj.reset_sim_state()
        z = self.sim_z.clone()
        z[self.obj_z_slices[obj_idx]] = obj.z
        self.sim_z = z

    # ---- queries ----
    def _get_object_transforms_internal(self, object_id):
        """Transforms in the normalized, pre-QR weight space, (H, 4, 4), in
        float64: K z with K in float64 (``qr_tfm64``), as a nearly singular
        K's float32 product loses them to cancellation. Every readout below
        starts from these and rounds once, at its end."""
        obj = self.sim_obj_dict[object_id]
        if self.sim_z is not None and self._ready_for_forces:
            tfms = self.sim_z[self.obj_z_slices[object_id]]
        else:
            tfms = obj.z
        tfms = tfms.double()
        if obj.apply_qr:
            tfms = obj.qr_tfm64 @ tfms
        tfms = tfms.reshape(-1, 3, 4)
        pad = tfms.new_zeros((tfms.shape[0], 1, 4))
        pad[:, 0, 3] = 1.0
        return torch.cat([tfms, pad], dim=1)

    def _renderable_weights(self, obj):
        """The renderable points' weights scaled as the simulated ones
        were, by the same float32 division, so that a renderable point at
        a simulated one moves as it does: where the transforms reach 1e5
        (a nearly singular K), the weights' rounding alone would move it."""
        weights = obj.renderable.skinning_weights
        if obj.normalize_weights_by_samples:
            weights = weights / obj.handle_norms[None, :]
        return weights

    def get_object_transforms(self, object_id):
        """Relative 4x4 transforms in raw physical space."""
        tfms = self._get_object_transforms_internal(object_id)
        obj = self.sim_obj_dict[object_id]
        if obj.normalize_weights_by_samples:
            tfms = torch.cat([tfms[:, :3, :]
                              / obj.handle_norms.double().reshape(-1, 1, 1),
                              tfms[:, 3:, :]], dim=1)
        return tfms.to(obj.dtype)

    def get_object_deformed_pts(self, obj_idx, points="simulated"):
        """The object's simulated or renderable points moved by LBS with its
        current transforms → (N, 3); the simulated ones as x0 + B z, the
        same LBS in z's own basis, the renderable ones by LBS in float64."""
        with profiling.span("physics.simplicits.deformed_pts"):
            obj = self.sim_obj_dict[obj_idx]
            if points == "rendered":
                if obj.renderable is None:
                    raise ValueError(
                        f"object {obj_idx} has no renderable points")
                pts = obj.renderable.pts
                tfms = self._get_object_transforms_internal(obj_idx)
                return standard_lbs(
                    pts.double(), tfms[None, :, :3, :],
                    self._renderable_weights(obj).double()).reshape(
                        pts.shape[0], 3).to(pts.dtype)
            if self.sim_z is not None and self._ready_for_forces:
                z = self.sim_z[self.obj_z_slices[obj_idx]]
            else:
                z = obj.z
            return obj.pts + (obj.B_dense @ z).reshape(-1, 3)

    def get_object_point_transforms(self, obj_idx, points="simulated"):
        """Absolute per-point 4x4 transforms, summed in float64."""
        obj = self.sim_obj_dict[obj_idx]
        weights = (self._renderable_weights(obj) if points == "rendered"
                   else obj.skinning_weights)
        transforms = self._get_object_transforms_internal(obj_idx)
        per_pt = torch.sum(weights.double()[..., None, None]
                           * transforms[None], dim=1)
        per_pt[:, :3, :3] += torch.eye(3, dtype=per_pt.dtype,
                                       device=per_pt.device)
        per_pt[:, 3, :] = 0.0
        per_pt[:, 3, 3] = 1.0
        return per_pt.to(weights.dtype)

    # ---- the step ----
    def build_functional_step(self, with_diag=False, fixed_trip=False):
        """The scene's implicit time step as a function over the scene
        constants → ``(step_fn, consts)`` with

        ``step_fn(consts, z, z_prev, z_dot) -> (z_new, z_prev_out, z_dot_new)``

        (``z_prev`` is not read: the step starts from z). ``with_diag=True``
        adds a fourth output, the step's int32 contact-overflow bitmask
        (:meth:`Collision.diag_flags`; 0 without contact).
        ``fixed_trip=True`` runs Newton's fixed trip whatever
        ``differentiable`` says. The step is :meth:`_newton_system`'s
        problem solved by ``newtons_method``."""
        return self._functional_step(with_diag, fixed_trip)

    def _functional_step(self, with_diag=False, fixed_trip=False,
                         count_contacts=False):
        """:meth:`build_functional_step`; ``count_contacts`` adds each
        detection's live pairs to ``CONTACTS`` while the profiler runs."""
        system, _, consts = self._newton_system(count_contacts)
        dt = self.timestep
        nm_kwargs = dict(nm_max_iters=self.max_newton_steps,
                         differentiable=self.differentiable or fixed_trip)

        def step(c, z, z_prev_in, z_dot):
            fns, kwargs, flags = system(c, z, z_dot)
            z_new = newtons_method(z, *fns, **kwargs, **nm_kwargs)
            z_dot_new = (z_new - z) / dt
            if with_diag:
                return z_new, z, z_dot_new, flags
            return z_new, z, z_dot_new

        return step, consts

    def _contact_in_z(self):
        """Whether the contact terms are taken in z's own basis (see
        :meth:`enable_collisions`)."""
        return any(o.contact_factors is not None
                   for o in self.sim_obj_dict.values())

    def _newton_system(self, count_contacts=False):
        """The step's Newton problem as a function over the scene constants
        → ``(system, detect, consts)`` with

        ``system(consts, z, z_dot, detected=None) -> ((energy, gradient,
        hessian), kwargs, flags)``

        for the step from z at velocity z_dot: the energy of the implicit
        step and its derivatives as functions of the new z, the rest of
        ``newton_iteration``'s arguments, and the step's int32
        contact-overflow bitmask (0 without contact).

        With contact, ``detect(consts, z, live=False) -> (contacts, flags,
        live)`` runs detection from z, inside the span
        ``physics.simplicits.detect`` (``live``: the live pairs, a 0-dim
        int64 tensor, else None; ``count_contacts``: added to
        ``CONTACTS`` while the profiler runs), and ``system`` runs it
        where it is not given ``detected``. The contacts carry the factors
        of their LBS rows, so the contact terms inside Newton are dense
        products with them: in z's own basis where the scene took it for
        contact (:meth:`enable_collisions`), else in the raw (pre-QR) basis,
        taken to z's basis by the QR rotation. Without contact ``detect``
        is None."""
        dt = self.timestep
        reg = self.newton_hessian_regularizer
        total_dofs = self.total_dofs
        dyn_idx = torch.as_tensor(self.dyn_idx, device=self.device)
        obj_slices = list(zip(self.obj_qp_slices, self.obj_z_slices))
        has_collision = ("collision" in self.force_dict
                         and not self._collision_provably_empty())
        collision_bounds = (has_collision
                            and self.force_dict["collision"]["object"].bounds)
        in_z = has_collision and self._contact_in_z()
        solver = dict(cg_tol=self.cg_tol, cg_iters=self.cg_iters,
                      conv_tol=self.conv_tol, direct_solve=self.direct_solve,
                      max_ls_steps=self.max_ls_steps)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        eye_d = torch.eye(total_dofs, dtype=self.dtype, device=self.device)
        objs = list(self.sim_obj_dict.values())
        consts = {
            "B": self.sim_B,
            "dFdz": self.sim_dFdz,
            "BMB": self.sim_BMB,
            "pts": self.sim_pts,
            "obj_Bs": [o.B_dense for o in objs],
            "obj_dFdzs": [o.dFdz_dense for o in objs],
            "qr_red": None if in_z else self.sim_qr_tfm_red,
            "qr_red_inv": None if in_z else self.sim_qr_tfm_inv_red,
            "pt_forces": [(f["object"], f["coeff"])
                          for f in self.force_dict["pt_wise"].values()],
            "defo_forces": [(f["object"], f["coeff"]) for f in
                            self.force_dict["defo_grad_wise"].values()],
        }
        no_flags = torch.zeros((), dtype=torch.int32, device=self.device)
        detect = None
        if has_collision:
            collision = self.force_dict["collision"]["object"]
            consts["collision"] = collision
            consts["collision_coeff"] = self.force_dict["collision"]["coeff"]
            consts["qp_obj_ids"] = self.qp_to_object_map
            consts["qp_is_kin"] = self.qp_is_kinematic
            consts["qp_is_phantom"] = self._phantoms()
            if in_z:
                # the global block-diagonal factors (N, 4 H_total) of each
                # point's LBS row in z's basis: A K₄ of a re-based object,
                # w ⊗ [x;1] of one without the QR
                consts["col_q"] = self._contact_factor_table(objs,
                                                             obj_slices)
            else:
                consts["qr_tfm"] = self.sim_qr_tfm
                # the global block-diagonal skinning weights (N, H_total),
                # from which detection makes the contacts' q-form factors
                wblocks = self.sim_pts.new_zeros((self.total_qp,
                                                  self.total_dofs // 12))
                h0 = 0
                for o, (qsl, _) in zip(objs, obj_slices):
                    wblocks[qsl, h0:h0 + o.num_handles] = o.skinning_weights
                    h0 += o.num_handles
                consts["col_w"] = wblocks
            if collision.broad_phase == "grid":
                # made here, outside any capture, and held by the graph
                consts["grid_tensors"] = collision.grid_tensors(self.device)

            def detect(c, z, live=False):
                with profiling.span(DETECT_SPAN):
                    contacts, det_diag = c["collision"].detect_collisions(
                        (c["B"] @ z).reshape(-1, 3), c["pts"],
                        c["qp_obj_ids"], c["qp_is_kin"],
                        weights=c.get("col_w"), factors=c.get("col_q"),
                        cp_exclude=c["qp_is_phantom"], return_diag=True)
                    n_live = (contacts.valid.sum()
                              if live or count_contacts else None)
                    if count_contacts:
                        _count_contacts(n_live)
                return contacts, Collision.diag_flags(det_diag), n_live

        def system(c, z, z_dot, detected=None):
            B, dFdz, BMB, pts = c["B"], c["dFdz"], c["BMB"], c["pts"]

            def dx_of(z_):
                return (B @ z_).reshape(-1, 3)

            def F_of(z_):
                return (dFdz @ z_).reshape(-1, 3, 3) + eye3

            def delta_of(z_):
                return z_ - z - dt * z_dot

            flags = no_flags
            contacts = None
            if has_collision:
                col, col_coeff = c["collision"], c["collision_coeff"]
                qr = None if in_z else c["qr_tfm"]
                contacts, flags, _ = (detect(c, z) if detected is None
                                      else detected)

                def zq_of(z_):
                    dzq = z_ - z
                    return dzq if qr is None else qr @ dzq

                def to_post(g_raw):
                    return g_raw if qr is None else qr.T @ g_raw

            def energy_fn(z_):
                dx = dx_of(z_)
                F = F_of(z_)
                delta = delta_of(z_)
                pe = 0.0
                for obj, coeff in c["pt_forces"]:
                    pe = pe + obj.energy(dx, pts, coeff)
                for obj, coeff in c["defo_forces"]:
                    pe = pe + obj.energy(F, coeff)
                if has_collision:
                    pe = pe + col.energy(contacts, coeff=col_coeff,
                                         zq=zq_of(z_))
                ke = 0.5 * delta @ (BMB @ delta)
                return ke + dt * dt * pe

            def grad_fn(z_):
                dx = dx_of(z_)
                F = F_of(z_)
                dEdx = torch.zeros_like(dx)
                for obj, coeff in c["pt_forces"]:
                    dEdx = dEdx + obj.gradient(dx, pts, coeff)
                dEdF = torch.zeros_like(F)
                for obj, coeff in c["defo_forces"]:
                    dEdF = dEdF + obj.gradient(F, coeff)
                g = B.T @ dEdx.reshape(-1) + dFdz.T @ dEdF.reshape(-1)
                if has_collision:
                    c_dEdx = col.gradient(contacts, coeff=col_coeff,
                                          zq=zq_of(z_))
                    g = g + to_post(col.pullback_gradient(contacts, c_dEdx))
                return BMB @ delta_of(z_) + dt * dt * g

            def hess_fn(z_):
                dx = dx_of(z_)
                F = F_of(z_)
                d2Edx2 = dx.new_zeros(dx.shape[:1] + (3, 3))
                for obj, coeff in c["pt_forces"]:
                    d2Edx2 = d2Edx2 + obj.hessian(dx, pts, coeff)
                d2EdF2 = F.new_zeros(F.shape[:1] + (9, 9))
                for obj, coeff in c["defo_forces"]:
                    d2EdF2 = d2EdF2 + obj.hessian(F, coeff)
                blocks = [hess_reduction(oB, d2Edx2[qsl])
                          + hess_reduction(odFdz, d2EdF2[qsl])
                          for oB, odFdz, (qsl, _) in zip(
                              c["obj_Bs"], c["obj_dFdzs"], obj_slices)]
                H = blocks[0] if len(blocks) == 1 else torch.block_diag(
                    *blocks)
                if has_collision:
                    c_h = col.hessian(contacts, coeff=col_coeff,
                                      zq=zq_of(z_))
                    c_H = col.reduced_hessian(contacts, c_h)
                    if qr is not None:
                        c_H = qr.T @ c_H @ qr
                    H = H + c_H
                return BMB + dt * dt * H + reg * eye_d

            bounds_fn = None
            if collision_bounds:
                def bounds_fn(dz_full, z_):
                    dzq = dz_full if qr is None else qr @ dz_full
                    return col.get_bounds_q(contacts, dzq, zq_of(z_))

            kwargs = dict(bounds_fcn=bounds_fn, dyn_idx=dyn_idx,
                          bounds_qr_tfm=c["qr_red"],
                          bounds_qr_tfm_inv=c["qr_red_inv"], **solver)
            return (energy_fn, grad_fn, hess_fn), kwargs, flags

        return system, detect, consts

    def _contact_factor_table(self, objs, obj_slices):
        """(N, 4 H_total): each point's contact factors in z's basis in its
        object's 4H columns, 0 elsewhere."""
        table = self.sim_pts.new_zeros((self.total_qp,
                                        4 * (self.total_dofs // 12)))
        h0 = 0
        for o, (qsl, _) in zip(objs, obj_slices):
            f = o.contact_factors
            if f is None:
                hom = torch.cat([o.pts, torch.ones_like(o.pts[:, :1])], 1)
                f = (o.skinning_weights[:, :, None]
                     * hom[:, None, :]).reshape(o.num_qp, -1)
            table[qsl, 4 * h0:4 * (h0 + o.num_handles)] = f
            h0 += o.num_handles
        return table

    def _check_ready(self):
        if not self._ready_for_forces:
            raise RuntimeError("Forces need to be set")

    def _flags(self):
        """The device flag the steps OR their overflow bits into."""
        if self._col_overflow is None:
            self._col_overflow = torch.zeros((), dtype=torch.int32,
                                             device=self.device)
        return self._col_overflow

    def _eager_step(self):
        if self._step_fn is None:
            self._step_fn = self._functional_step(with_diag=True,
                                                  count_contacts=True)
        step, consts = self._step_fn
        with torch.no_grad():
            (self.sim_z, self.sim_z_prev, self.sim_z_dot,
             flags) = step(consts, self.sim_z, self.sim_z_prev,
                           self.sim_z_dot)
            self._col_overflow = self._flags() | flags

    def _graph_takes_lu(self):
        """With contact the Hessian is not symmetric (friction) and often
        indefinite, so the Cholesky fails in many steps: the graph then
        solves by LU too and takes it where the Cholesky failed, rather than
        run those steps again eagerly."""
        return ("collision" in self.force_dict
                and not self._collision_provably_empty())

    def _capture(self):
        """The step captured in CUDA graphs that advance the static state
        buffers (z, z_prev, z_dot and the overflow flag) in place →
        (graphs, state, status, lu_steps, keep).

        Without the LU (:meth:`_graph_takes_lu`), three graphs run Newton's
        iterations as the early-exit loop runs them (:meth:`_segments`):
        ``start``, ``iterate`` and ``finish``, with ``status`` the device's
        [converged, failed] flags, which :meth:`_replay` reads after
        ``start`` and after each ``iterate``. With the LU, Newton's fixed
        trip, which counts the steps that took the LU in ``lu_steps``, in
        a graph ``newton``, after a graph ``detect`` where there is contact
        (the contacts from z, the overflow bits and the live pairs), the
        two replayed back to back: no step there runs again, so the
        replays of a :meth:`_replay` run with one read, where an early exit
        would read a flag every step.

        A replay reads the tensors the step was built over at the addresses
        they had at the capture: ``keep`` holds the step and its constants
        (the identity matrices, the dynamic-DOF index, the contact weights
        and grid tensors, the ``Collision``) and every buffer one graph
        hands another (with the LU, ``keep["detected"]``: the contacts,
        the flags and the live pairs), so that none of them is freed and
        its memory handed to another tensor while the graphs live."""
        state = [b.clone() for b in self._live_state()]
        if not self._graph_takes_lu():
            status = torch.zeros(2, dtype=torch.bool, device=self.device)
            fns, keep = self._segments(state, status)
            return self._record_graphs(fns), state, status, None, keep
        system, detect, consts = self._newton_system()
        failed = torch.zeros((), dtype=torch.bool, device=self.device)
        lu_steps = torch.zeros((), dtype=torch.int32, device=self.device)
        z, z_prev, z_dot, ovf = state
        held = {}
        dt = self.timestep

        def find():
            with torch.no_grad():
                held["detected"] = detect(consts, z, live=True)
        held["detected"] = None

        def advance():
            with torch.no_grad(), cholesky_only(failed, with_lu=True):
                failed.zero_()
                fns, kwargs, flags = system(consts, z, z_dot,
                                            held["detected"])
                z1 = newtons_method(z, *fns, **kwargs,
                                    nm_max_iters=self.max_newton_steps,
                                    differentiable=True)
                zd1 = (z1 - z) / dt
                z_prev.copy_(z)
                z_dot.copy_(zd1)
                z.copy_(z1)
                ovf.bitwise_or_(flags)
                lu_steps.add_(failed)

        graphs = self._record_graphs([advance] if detect is None
                                     else [find, advance])
        lu_steps.zero_()
        held.update(system=system, detect=detect, consts=consts)
        return graphs, state, None, lu_steps, held

    def _segments(self, state, status):
        """The step without the LU as three functions of no argument over
        the static buffers ``state`` and ``status`` → ((start, iterate,
        finish), keep):

        - ``start``: ``status`` cleared, Newton's set-up from z and its
          first ``START_ITERATIONS`` iterations (all of them where
          ``max_newton_steps`` is fewer);
        - ``iterate``: one more iteration;
        - ``finish``: z_prev, z_dot and z written from Newton's x, and the
          step's overflow bits ORed into the flag.

        Newton's x, its convergence flag (``status[0]``) and the Cholesky's
        failure flag (``status[1]``, through ``cholesky_only``, which keeps
        the Cholesky solution) are updated in place, so one function hands
        the next static buffers only. An iteration tests convergence at its
        own start and leaves x as it is once converged: every step that
        moves runs two iterations at least, and the second after a first
        that converged changes nothing. Only ``finish`` writes the state,
        so a step whose Cholesky failed can run again from it."""
        system, _, consts = self._newton_system()
        z, z_prev, z_dot, ovf = state
        converged, failed = status[0], status[1]
        x = torch.empty_like(z)
        newton = {}
        dt = self.timestep
        first = min(START_ITERATIONS, self.max_newton_steps)

        def iterate():
            with torch.no_grad(), cholesky_only(failed):
                x_new, now_converged = newton["iter"](x, converged)
                x.copy_(x_new)
                converged.copy_(now_converged)

        def start():
            with torch.no_grad():
                status.zero_()
                x.copy_(z)
                fns, kwargs, newton["flags"] = system(consts, z, z_dot)
                newton["iter"] = newton_iteration(x, *fns, **kwargs)
            for _ in range(first):
                iterate()

        def finish():
            with torch.no_grad():
                z_dot_new = (x - z) / dt
                z_prev.copy_(z)
                z_dot.copy_(z_dot_new)
                z.copy_(x)
                ovf.bitwise_or_(newton["flags"])

        return (start, iterate, finish), (system, consts, x, newton)

    def _record_graphs(self, fns):
        """Each of ``fns`` (functions of no argument over static buffers)
        captured in a CUDA graph → the graphs, in order. They are warmed up
        in turn on a side stream first (workspaces, the step-size grid), as
        ``torch.cuda.graphs`` asks, then captured in turn on torch's one
        capture stream into the first graph's memory pool: the graphs may
        share their temporaries' memory, so they replay one at a time, and
        what one hands another stays allocated."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        current.wait_stream(side)
        graphs, pool = [], None
        for fn in fns:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                fn()
            pool = graph.pool() if pool is None else pool
            graphs.append(graph)
        return graphs

    def _live_state(self):
        return (self.sim_z, self.sim_z_prev, self.sim_z_dot, self._flags())

    def _replay(self, num_steps):
        """``num_steps`` steps from the scene's state by the graphs of
        :meth:`_capture`. Without the LU, each step by
        :meth:`_replay_segments`; a step whose Cholesky failed is run again
        eagerly from its start, with the LU fallback (``graph_steps_rerun``
        counts them). With it, the replays run back to back, and the steps
        that took the LU are read once at the end (``graph_steps_lu``)."""
        if self._graph is None:
            with profiling.span("physics.simplicits.capture"):
                self._graph = self._capture()
            profiling.count(CAPTURES)
        graphs, state, status, lu_steps, keep = self._graph
        for buf, value in zip(state, self._live_state()):
            buf.copy_(value)
        for _ in range(num_steps):
            if lu_steps is not None:
                if len(graphs) == 2:
                    with profiling.span(DETECT_SPAN):
                        graphs[0].replay()
                        _count_contacts(keep["detected"][2])
                with profiling.span("physics.simplicits.replay"):
                    graphs[-1].replay()
                profiling.count(NEWTON_ITERATIONS, self.max_newton_steps)
            elif not self._replay_segments(graphs, status):
                with profiling.span("physics.simplicits.rerun"):
                    (self.sim_z, self.sim_z_prev, self.sim_z_dot,
                     self._col_overflow) = (b.clone() for b in state)
                    self._eager_step()
                    for buf, value in zip(state, self._live_state()):
                        buf.copy_(value)
                self.graph_steps_rerun += 1
            profiling.count(GRAPH_REPLAYS)
        if lu_steps is not None:
            with profiling.span("physics.simplicits.replay"):
                self.graph_steps_lu += int(lu_steps)
            lu_steps.zero_()
        (self.sim_z, self.sim_z_prev, self.sim_z_dot,
         self._col_overflow) = (b.clone() for b in state)

    def _replay_segments(self, graphs, status):
        """One step by the graphs of :meth:`_segments`: ``start``, then
        ``iterate`` while one host read of ``status`` finds neither flag set
        and fewer than ``max_newton_steps`` iterations have run, then
        ``finish`` → False where the Cholesky failed, which leaves the state
        as the step found it. ``NEWTON_ITERATIONS`` counts the iterations
        run."""
        start, iterate, finish = graphs
        with profiling.span("physics.simplicits.replay"):
            start.replay()
            ran = min(START_ITERATIONS, self.max_newton_steps)
            converged, failed = status.tolist()
            while not (converged or failed) and ran < self.max_newton_steps:
                with profiling.span("physics.simplicits.iterate"):
                    iterate.replay()
                    converged, failed = status.tolist()
                ran += 1
            if not failed:
                finish.replay()
        profiling.count(NEWTON_ITERATIONS, ran)
        return not failed

    def run_sim_step(self):
        """One implicit time step: the captured graph replayed once when
        ``use_cuda_graphs``, else the step's ops one by one. With contact,
        every ``collision_resize_interval`` steps the overflow flag is read
        (:meth:`check_collision_capacity`) while ``collision_auto_resize``."""
        self._check_ready()
        with profiling.span("physics.simplicits.step"):
            if self.use_cuda_graphs:
                self._replay(1)
            else:
                self._eager_step()
            self.current_sim_step += 1
            if (self.collision_auto_resize and "collision" in self.force_dict
                    and self.current_sim_step % self.collision_resize_interval
                    == 0):
                self.check_collision_capacity()

    def run_sim_steps(self, num_steps):
        """``num_steps`` time steps, the same as as many
        :meth:`run_sim_step` calls but for the capacity check, made once
        after them: with ``use_cuda_graphs`` the graph replayed
        ``num_steps`` times with one copy in and out."""
        self._check_ready()
        with profiling.span("physics.simplicits.step"):
            if self.use_cuda_graphs:
                self._replay(int(num_steps))
            else:
                for _ in range(int(num_steps)):
                    self._eager_step()
            self.current_sim_step += int(num_steps)
            if self.collision_auto_resize and "collision" in self.force_dict:
                self.check_collision_capacity()

    def check_collision_capacity(self):
        """Read the overflow flag the steps ORed on the device (one scalar)
        → the bitmask, 0 when healthy. When set, the capacities are
        re-measured from the current configuration with growing headroom,
        and the step and graph are built anew at the next step (the
        overflowing steps are not undone)."""
        if "collision" not in self.force_dict or self._col_overflow is None:
            return 0
        flags = int(self._col_overflow)
        if flags == 0:
            return 0
        self._resize_collision_capacities(flags)
        return flags

    def _resize_collision_capacities(self, flags):
        # the graph and its buffers go before anything it reads changes
        self._invalidate()
        col = self.force_dict["collision"]["object"]
        self.collision_resizes += 1
        headroom = 1.5 * (2.0 ** min(self.collision_resizes - 1, 4))
        with torch.no_grad():
            cur = (self.sim_pts + (self.sim_B @ self.sim_z).reshape(-1, 3)
                   ).cpu().numpy()
        if col.broad_phase == "grid":
            def sizes():
                return (col.grid_dims, col.cell_capacity,
                        col.max_occupied_cells)

            old = sizes()
            real = self._qp_is_real
            col.configure_grid(
                cur[real], obj_ids=self.qp_to_object_map.cpu().numpy()[real],
                headroom=headroom,
                bounds_pts=self.sim_pts.cpu().numpy()[real])
            warnings.warn(
                f"collision capacity overflow (flags={flags:#x}); grid "
                f"re-measured from the current configuration: dims/K/M "
                f"{old} -> {sizes()} (resize #{self.collision_resizes}; "
                f"the step is built anew)")
        if flags & Collision.FLAG_CONTACTS_OVERFLOW:
            col.max_contacts = int(min(
                max(col.max_contacts * 2, 1024),
                self.total_qp * (self.total_qp - 1) // 2))
        if flags & Collision.FLAG_PP_OVERFLOW:
            col.point_contact_capacity = int(min(
                max(col.point_contact_capacity * 2, 8),
                14 * col.cell_capacity))
        if flags & Collision.FLAG_WINDOW_OVERFLOW:
            col.sweep_window = int(min(col.sweep_window * 2, self.total_qp))
        self._col_overflow = None
