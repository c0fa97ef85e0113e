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
captures one step (its fixed-trip Newton loop, Cholesky solves only) in a
``torch.cuda.CUDAGraph`` over static state buffers, and each step replays
it; a step whose Cholesky failed runs again eagerly, with the LU fallback.
Collisions are not ported yet (ROADMAP, Queue A 2).
"""

import numpy as np
import torch

from kaolin_tpu_torch.physics.common.optimization import (
    cholesky_only,
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

__all__ = ["SimulatedObject", "SimplicitsScene"]

def _resolve_device(device):
    """``device``, or the CUDA device when it is None. Without a CUDA device
    a None raises: a scene never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("SimplicitsScene runs on the CUDA device and none "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


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
        if apply_qr:
            self._apply_qr_decomposition()

        self.z = None
        self.z_prev = None
        self.z_dot = None
        self.reset_sim_state()

    def _apply_qr_decomposition(self):
        """Column-pivoted economic QR of B for conditioning, on the host
        with scipy (set-up only): B Π = Q R, K = Π R⁻¹, so B K = Q and
        dFdz becomes dFdz K."""
        from scipy.linalg import qr, solve_triangular
        np_b = self.B_dense.cpu().numpy()
        _, np_r, np_p = qr(np_b, mode="economic", pivoting=True)
        pmat = np.eye(np_b.shape[1], dtype=np_b.dtype)[:, np_p]
        rinv = solve_triangular(np_r, np.eye(np_r.shape[0], dtype=np_r.dtype))
        device = self.B_dense.device
        self.qr_tfm = torch.from_numpy(pmat @ rinv).to(device)
        self.qr_tfm_inv = torch.from_numpy(np_r @ pmat.T).to(device)
        self.B_dense = self.B_dense @ self.qr_tfm
        if not self.is_kinematic:
            self.dFdz_dense = self.dFdz_dense @ self.qr_tfm

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
    without one. ``use_cuda_graphs``: capture a step in a CUDA graph and
    replay it (CUDA only); the graph runs Newton's fixed trip, which gives
    the early-exit loop's z bit for bit, and reads one flag a step (see
    :meth:`_replay`). ``differentiable``: the fixed trip on the eager path
    too."""

    def __init__(self, direct_solve=True, timestep=0.03, max_newton_steps=5,
                 max_ls_steps=10, newton_hessian_regularizer=1e-4,
                 cg_tol=1e-4, cg_iters=100, conv_tol=1e-4, device=None,
                 use_cuda_graphs=False, differentiable=False):
        self.device = _resolve_device(device)
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

        self.sim_z = None
        self.sim_z_prev = None
        self.sim_z_dot = None

    def _invalidate(self):
        """Forget the built step and graph: the forces changed."""
        self._step_fn = None
        self._graph = None

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
        for obj in objs:
            self.obj_qp_slices.append(slice(qp0, qp0 + obj.num_qp))
            self.obj_z_slices.append(slice(z0, z0 + 12 * obj.num_handles))
            if obj.is_kinematic:
                kin_dofs.extend(range(z0, z0 + 12 * obj.num_handles))
            qp0 += obj.num_qp
            z0 += 12 * obj.num_handles
        self.total_qp = qp0
        self.total_dofs = z0
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

    def enable_collisions(self, *args, **kwargs):
        """Not ported yet (ROADMAP, Queue A 2)."""
        raise NotImplementedError(
            "enable_collisions is not ported yet (ROADMAP Queue A 2: "
            "Simplicits collisions and training)")

    # ---- state ----
    def reset_scene(self):
        self.current_sim_step = 0
        for obj in self.sim_obj_dict.values():
            obj.reset_sim_state()
        self.sim_z = torch.cat([o.z for o in self.sim_obj_dict.values()])
        self.sim_z_prev = torch.zeros_like(self.sim_z)
        self.sim_z_dot = torch.zeros_like(self.sim_z)

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
        """Transforms in the normalized, pre-QR weight space, (H, 4, 4)."""
        obj = self.sim_obj_dict[object_id]
        if self.sim_z is not None and self._ready_for_forces:
            tfms = self.sim_z[self.obj_z_slices[object_id]]
        else:
            tfms = obj.z
        if obj.apply_qr:
            tfms = obj.qr_tfm @ tfms
        tfms = tfms.reshape(-1, 3, 4)
        pad = tfms.new_zeros((tfms.shape[0], 1, 4))
        pad[:, 0, 3] = 1.0
        return torch.cat([tfms, pad], dim=1)

    def get_object_transforms(self, object_id):
        """Relative 4x4 transforms in raw physical space."""
        tfms = self._get_object_transforms_internal(object_id)
        obj = self.sim_obj_dict[object_id]
        if obj.normalize_weights_by_samples:
            tfms = torch.cat([tfms[:, :3, :]
                              / obj.handle_norms.reshape(-1, 1, 1),
                              tfms[:, 3:, :]], dim=1)
        return tfms

    def get_object_deformed_pts(self, obj_idx, points="simulated"):
        """The object's simulated or renderable points moved by LBS with its
        current transforms → (N, 3)."""
        obj = self.sim_obj_dict[obj_idx]
        if points == "rendered":
            if obj.renderable is None:
                raise ValueError(f"object {obj_idx} has no renderable points")
            pts = obj.renderable.pts
            weights = obj.renderable.skinning_weights
            tfms = self.get_object_transforms(obj_idx)[:, :3, :]
        else:
            pts = obj.pts
            weights = obj.skinning_weights
            tfms = self._get_object_transforms_internal(obj_idx)[:, :3, :]
        return standard_lbs(pts, tfms[None], weights).reshape(pts.shape[0], 3)

    def get_object_point_transforms(self, obj_idx, points="simulated"):
        """Absolute per-point 4x4 transforms."""
        obj = self.sim_obj_dict[obj_idx]
        if points == "rendered":
            weights = obj.renderable.skinning_weights
            transforms = self.get_object_transforms(obj_idx)
        else:
            weights = obj.skinning_weights
            transforms = self._get_object_transforms_internal(obj_idx)
        per_pt = torch.sum(weights[..., None, None] * transforms[None], dim=1)
        per_pt[:, :3, :3] += torch.eye(3, dtype=per_pt.dtype,
                                       device=per_pt.device)
        per_pt[:, 3, :] = 0.0
        per_pt[:, 3, 3] = 1.0
        return per_pt

    # ---- the step ----
    def build_functional_step(self, with_diag=False, fixed_trip=False):
        """The scene's implicit time step as a function over the scene
        constants → ``(step_fn, consts)`` with

        ``step_fn(consts, z, z_prev, z_dot) -> (z_new, z_prev_out, z_dot_new)``

        (``z_prev`` is not read: the step starts from z). ``with_diag=True``
        adds a fourth output, the int32 collision-overflow flags, always 0
        here (collisions are not ported). ``fixed_trip=True`` runs Newton's
        fixed trip whatever ``differentiable`` says."""
        dt = self.timestep
        reg = self.newton_hessian_regularizer
        total_dofs = self.total_dofs
        dyn_idx = torch.as_tensor(self.dyn_idx, device=self.device)
        obj_slices = list(zip(self.obj_qp_slices, self.obj_z_slices))
        nm_kwargs = dict(nm_max_iters=self.max_newton_steps,
                         cg_tol=self.cg_tol, cg_iters=self.cg_iters,
                         conv_tol=self.conv_tol,
                         direct_solve=self.direct_solve,
                         max_ls_steps=self.max_ls_steps,
                         differentiable=self.differentiable or fixed_trip)
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
            "qr_red": self.sim_qr_tfm_red,
            "qr_red_inv": self.sim_qr_tfm_inv_red,
            "pt_forces": [(f["object"], f["coeff"])
                          for f in self.force_dict["pt_wise"].values()],
            "defo_forces": [(f["object"], f["coeff"]) for f in
                            self.force_dict["defo_grad_wise"].values()],
        }

        def step(c, z, z_prev_in, z_dot):
            B, dFdz, BMB, pts = c["B"], c["dFdz"], c["BMB"], c["pts"]

            def dx_of(z_):
                return (B @ z_).reshape(-1, 3)

            def F_of(z_):
                return (dFdz @ z_).reshape(-1, 3, 3) + eye3

            def delta_of(z_):
                return z_ - z - dt * z_dot

            def energy_fn(z_):
                dx = dx_of(z_)
                F = F_of(z_)
                delta = delta_of(z_)
                pe = 0.0
                for obj, coeff in c["pt_forces"]:
                    pe = pe + obj.energy(dx, pts, coeff)
                for obj, coeff in c["defo_forces"]:
                    pe = pe + obj.energy(F, coeff)
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
                return BMB + dt * dt * H + reg * eye_d

            z_new = newtons_method(
                z, energy_fn, grad_fn, hess_fn, dyn_idx=dyn_idx,
                bounds_qr_tfm=c["qr_red"], bounds_qr_tfm_inv=c["qr_red_inv"],
                **nm_kwargs)
            z_dot_new = (z_new - z) / dt
            if with_diag:
                return z_new, z, z_dot_new, torch.zeros(
                    (), dtype=torch.int32, device=z.device)
            return z_new, z, z_dot_new

        return step, consts

    def _check_ready(self):
        if not self._ready_for_forces:
            raise RuntimeError("Forces need to be set")

    def _eager_step(self):
        if self._step_fn is None:
            self._step_fn = self.build_functional_step()
        step, consts = self._step_fn
        with torch.no_grad():
            self.sim_z, self.sim_z_prev, self.sim_z_dot = step(
                consts, self.sim_z, self.sim_z_prev, self.sim_z_dot)

    def _capture(self):
        """One fixed-trip step captured in a CUDA graph that advances the
        static state buffers in place → (graph, state, start, failed,
        keep). The graph first copies the state into ``start``, takes every
        Cholesky solution as it is and ORs any failure into ``failed``,
        which :meth:`_replay` reads after each replay.

        A replay reads the tensors the step was built over at the addresses
        they had at the capture: ``keep`` holds the step and its constants
        (the identity matrices and the dynamic-DOF index live only in the
        step's closure), so that none of them is freed and its memory handed
        to another tensor while the graph lives."""
        step, consts = self.build_functional_step(fixed_trip=True)
        state = [self.sim_z.clone(), self.sim_z_prev.clone(),
                 self.sim_z_dot.clone()]
        start = [torch.empty_like(b) for b in state]
        failed = torch.zeros((), dtype=torch.bool, device=self.device)

        def advance():
            failed.zero_()
            for keep, buf in zip(start, state):
                keep.copy_(buf)
            z, z_prev, z_dot = state
            z1, _, zd1 = step(consts, z, z_prev, z_dot)
            z_prev.copy_(z)
            z_dot.copy_(zd1)
            z.copy_(z1)

        # warm up on a side stream (workspaces, the step-size grid), as
        # torch.cuda.graphs asks; the state is copied in before the replays
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side), cholesky_only(failed):
            advance()
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad(), torch.cuda.graph(graph), cholesky_only(failed):
            advance()
        return graph, state, start, failed, (step, consts)

    def _replay(self, num_steps):
        """``num_steps`` replays from the scene's state, with one host read
        of ``failed`` after each: a step whose Cholesky failed is run again
        eagerly from its start, with the LU fallback
        (``graph_steps_rerun`` counts them)."""
        if self._graph is None:
            self._graph = self._capture()
        graph, state, start, failed, _ = self._graph
        for buf, value in zip(state, (self.sim_z, self.sim_z_prev,
                                      self.sim_z_dot)):
            buf.copy_(value)
        for _ in range(num_steps):
            graph.replay()
            if bool(failed):
                self.sim_z, self.sim_z_prev, self.sim_z_dot = (
                    b.clone() for b in start)
                self._eager_step()
                self.graph_steps_rerun += 1
                for buf, value in zip(state, (self.sim_z, self.sim_z_prev,
                                              self.sim_z_dot)):
                    buf.copy_(value)
        self.sim_z, self.sim_z_prev, self.sim_z_dot = (b.clone()
                                                       for b in state)

    def run_sim_step(self):
        """One implicit time step: the captured graph replayed once when
        ``use_cuda_graphs``, else the step's ops one by one."""
        self._check_ready()
        if self.use_cuda_graphs:
            self._replay(1)
        else:
            self._eager_step()
        self.current_sim_step += 1

    def run_sim_steps(self, num_steps):
        """``num_steps`` time steps, the same as as many
        :meth:`run_sim_step` calls: with ``use_cuda_graphs`` the graph
        replayed ``num_steps`` times with one copy in and out."""
        self._check_ready()
        if self.use_cuda_graphs:
            self._replay(int(num_steps))
        else:
            for _ in range(int(num_steps)):
                self._eager_step()
        self.current_sim_step += int(num_steps)
