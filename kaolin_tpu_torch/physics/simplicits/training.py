"""Simplicits objects: material points, baked skinning, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/training.py``: the point
containers and :class:`SimplicitsObject` with its constructors (rigid,
analytic, an MLP skinning field trained by Adam, RKPM weights) and its
baking. Training runs on the device of the object's points: a step draws
its sample points and handle transforms, evaluates the losses of
:mod:`~kaolin_tpu_torch.physics.simplicits.losses` and takes one
``torch.optim.Adam`` step, with no read back to the host but the logged
losses.
"""

import logging
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from kaolin_tpu_torch.physics.simplicits import losses
from kaolin_tpu_torch.physics.simplicits.network import (
    SimplicitsMLP,
    SkinningModule,
)

logger = logging.getLogger(__name__)

__all__ = [
    "PhysicsPoints",
    "PhysicsPointsProtocol",
    "SkinnedPoints",
    "SkinnedPointsProtocol",
    "SkinnedPhysicsPoints",
    "SkinnedPhysicsPointsProtocol",
    "SimplicitsObject",
]


def _tensor(x):
    """A tensor of ``x`` (an array, a tensor or a scalar), on its own
    device when it is a tensor and on the CPU otherwise; float64 becomes
    float32, as in the JAX package (which runs without x64)."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.float() if t.dtype == torch.float64 else t


def _per_point(val, n, like):
    val = torch.as_tensor(val, dtype=like.dtype, device=like.device)
    if val.ndim == 0:
        val = torch.full((n,), float(val), dtype=like.dtype,
                         device=like.device)
    return val.reshape(-1)


@runtime_checkable
class PhysicsPointsProtocol(Protocol):
    """Point-sampled object with per-point material properties (pts, yms,
    prs, rhos, appx_vol and ``subsample``)."""
    pts: Any
    yms: Any
    prs: Any
    rhos: Any
    appx_vol: Any

    def subsample(self, num_pts=None, sample_indices=None):
        ...


@runtime_checkable
class SkinnedPointsProtocol(Protocol):
    """Points with per-point skinning weights: enough to move a renderable
    representation (e.g. gaussian splats) by LBS."""
    pts: Any
    skinning_weights: Any


@runtime_checkable
class SkinnedPhysicsPointsProtocol(Protocol):
    """What the simulator needs of a baked object: material points,
    skinning weights, their spatial Jacobian ``dwdx`` and optional
    renderable points."""
    pts: Any
    yms: Any
    prs: Any
    rhos: Any
    appx_vol: Any
    skinning_weights: Any
    dwdx: Any
    renderable: Any


class PhysicsPoints:
    """Material sample points: pts (N, 3), per-point yms/prs/rhos (scalars
    are broadcast), appx_vol."""

    def __init__(self, pts, yms, prs, rhos, appx_vol):
        self.pts = _tensor(pts)
        n = self.pts.shape[0]
        self.yms = _per_point(yms, n, self.pts)
        self.prs = _per_point(prs, n, self.pts)
        self.rhos = _per_point(rhos, n, self.pts)
        self.appx_vol = float(appx_vol)

    def __len__(self):
        return self.pts.shape[0]

    @property
    def dtype(self):
        return self.pts.dtype

    def _get_subsample_indices(self, num_pts=None, sample_indices=None):
        if (num_pts is None) == (sample_indices is None):
            raise ValueError("provide exactly one of num_pts / sample_indices")
        if sample_indices is not None:
            return np.asarray(sample_indices)
        n = len(self)
        if num_pts >= n:
            return np.arange(n)
        return np.random.RandomState(0).choice(n, size=num_pts, replace=False)

    def subsample(self, num_pts=None, sample_indices=None):
        """A random (seeded) or explicit subsample → new PhysicsPoints."""
        idx = self._get_subsample_indices(num_pts, sample_indices)
        return PhysicsPoints(self.pts[idx], self.yms[idx], self.prs[idx],
                             self.rhos[idx], self.appx_vol)


class SkinnedPoints:
    """Points and their baked skinning weights: enough to move a renderable
    representation by LBS."""

    def __init__(self, pts, skinning_weights):
        self.pts = _tensor(pts)
        self.skinning_weights = _tensor(skinning_weights)

    @property
    def num_handles(self):
        return self.skinning_weights.shape[1]

    @classmethod
    def from_skinning_mod(cls, pts, skinning_mod: SkinningModule):
        pts = _tensor(pts)
        with torch.no_grad():
            return cls(pts, skinning_mod.compute_skinning_weights(pts))

    def __len__(self):
        return self.pts.shape[0]


class SkinnedPhysicsPoints(PhysicsPoints):
    """Physics points, baked weights and their spatial gradients dwdx:
    everything a scene needs. Points past ``num_real_qp`` (None: none) are
    padding of zero volume and mass."""

    def __init__(self, pts, yms, prs, rhos, appx_vol, skinning_weights, dwdx,
                 renderable: SkinnedPoints = None, num_real_qp=None):
        super().__init__(pts, yms, prs, rhos, appx_vol)
        self.skinning_weights = _tensor(skinning_weights)
        self.dwdx = _tensor(dwdx)
        self.renderable = renderable
        self.num_real_qp = num_real_qp

    @property
    def num_handles(self):
        return self.skinning_weights.shape[1]

    @classmethod
    def from_skinning_mod(cls, pts, yms, prs, rhos, appx_vol,
                          skinning_mod: SkinningModule, renderable_pts=None):
        """Bake weights and their spatial gradients from a skinning
        module."""
        pts = _tensor(pts)
        with torch.no_grad():
            weights = skinning_mod.compute_skinning_weights(pts)
        dwdx = skinning_mod.compute_dwdx(pts).detach()
        renderable = None
        if renderable_pts is not None:
            renderable = SkinnedPoints.from_skinning_mod(renderable_pts,
                                                         skinning_mod)
        return cls(pts, yms, prs, rhos, appx_vol, weights, dwdx,
                   renderable=renderable)

    def subsample(self, num_pts=None, sample_indices=None):
        idx = self._get_subsample_indices(num_pts, sample_indices)
        return SkinnedPhysicsPoints(
            self.pts[idx], self.yms[idx], self.prs[idx], self.rhos[idx],
            self.appx_vol, self.skinning_weights[idx], self.dwdx[idx],
            renderable=self.renderable)


class SimplicitsObject(PhysicsPoints):
    """Physics points and a skinning weight field: analytic, a trained MLP
    or RKPM eigenmodes."""

    def __init__(self, pts, yms, prs, rhos, appx_vol,
                 skinning_mod: SkinningModule):
        super().__init__(pts, yms, prs, rhos, appx_vol)
        self.skinning_mod = skinning_mod

    @classmethod
    def create_rigid(cls, physics_points: PhysicsPoints):
        """The constant handle alone: rigid and affine motion only."""
        skin = SkinningModule.from_function(
            lambda x: x.new_zeros((x.shape[0], 0))).to(
                physics_points.pts.device)
        return cls(physics_points.pts, physics_points.yms,
                   physics_points.prs, physics_points.rhos,
                   physics_points.appx_vol, skin)

    @classmethod
    def create_from_function(cls, physics_points: PhysicsPoints, fcn):
        """An analytic weight function of normalized points; its box on the
        points' device."""
        return cls(physics_points.pts, physics_points.yms,
                   physics_points.prs, physics_points.rhos,
                   physics_points.appx_vol,
                   SkinningModule.from_function(fcn).to(
                       physics_points.pts.device))

    @classmethod
    def create_with_mlp(cls,
                        physics_points: PhysicsPoints,
                        num_handles,
                        num_samples,
                        model_layers,
                        training_batch_size=10,
                        training_num_steps=10000,
                        training_lr_start=1e-3,
                        training_lr_end=1e-3,
                        training_le_coeff=1e-1,
                        training_lo_coeff=1e6,
                        training_log_every=1000,
                        normalize_for_training=True,
                        key=None):
        """Train an MLP skinning-weight field on the points' device: the
        points normalized to their box, ``training_num_steps`` Adam steps on
        the elastic and orthogonality losses, the elastic energy blended
        from linear to neohookean over the steps (step i at i / steps).

        ``key``: a ``torch.Generator`` or an int seed (None: 0) of a
        generator on the points' device; the MLP's initialization and every
        step's draws come from it. One constant handle
        (``num_handles == 1``) gives :meth:`create_rigid`. The losses are
        logged (``logging``, this module's logger) every
        ``training_log_every`` steps."""
        if num_handles < 1:
            raise ValueError(f"num_handles {num_handles} < 1")
        if num_handles == 1:
            return cls.create_rigid(physics_points)
        pts = physics_points.pts
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=pts.device).manual_seed(
                0 if key is None else int(key))
        if normalize_for_training:
            bb_min, bb_max = pts.amin(dim=0), pts.amax(dim=0)
            bb_vol = float(torch.prod(bb_max - bb_min))
            training_pts = (pts - bb_min) / (bb_max - bb_min)
            training_appx_vol = physics_points.appx_vol / bb_vol
        else:
            bb_min, bb_max = None, None
            training_pts = pts
            training_appx_vol = physics_points.appx_vol
        skin = SimplicitsMLP(3, 64, num_handles, model_layers, bb_min=bb_min,
                             bb_max=bb_max, key=gen).to(pts.device)
        _train_mlp(skin, training_pts, physics_points, training_appx_vol,
                   gen, num_samples=num_samples,
                   batch_size=training_batch_size,
                   num_steps=training_num_steps,
                   lr_start=training_lr_start, lr_end=training_lr_end,
                   le_coeff=training_le_coeff, lo_coeff=training_lo_coeff,
                   log_every=training_log_every)
        return cls(pts, physics_points.yms, physics_points.prs,
                   physics_points.rhos, physics_points.appx_vol, skin)

    @classmethod
    def create_with_rkpm(cls, physics_points: PhysicsPoints, num_handles,
                         num_nodes, num_points=None, radius_scale=1.0,
                         radius_init_kNN=2, radius_min="3x", dtype=None):
        """Skinning weights from RKPM generalized eigenmodes (NVIDIA's
        "Freeform"): deterministic, no training. The basis is built on the
        host in float64; its nodes are sampled on the points' device."""
        from kaolin_tpu_torch.physics.simplicits.rkpm import SimplicitsRKPM

        pts = physics_points.pts
        skin = SimplicitsRKPM(num_handles=num_handles, num_nodes=num_nodes,
                              radius_scale=radius_scale,
                              radius_init_kNN=radius_init_kNN,
                              radius_min=radius_min, num_points=num_points,
                              bb_min=pts.amin(dim=0), bb_max=pts.amax(dim=0))
        skin.init(pts, physics_points.yms, physics_points.prs,
                  physics_points.rhos, physics_points.appx_vol)
        return cls(pts, physics_points.yms, physics_points.prs,
                   physics_points.rhos, physics_points.appx_vol, skin)

    def subsample(self, num_pts=None, sample_indices=None):
        idx = self._get_subsample_indices(num_pts, sample_indices)
        return SimplicitsObject(self.pts[idx], self.yms[idx], self.prs[idx],
                                self.rhos[idx], self.appx_vol,
                                self.skinning_mod)

    def bake(self, num_qps=None, sampling_indices=None,
             renderable_pts=None) -> SkinnedPhysicsPoints:
        """Weights and gradients at sampled quadrature points."""
        if num_qps is None and sampling_indices is None:
            raise ValueError("bake() requires num_qps or sampling_indices")
        sampled = self.subsample(num_pts=num_qps,
                                 sample_indices=sampling_indices)
        return SkinnedPhysicsPoints.from_skinning_mod(
            pts=sampled.pts, yms=sampled.yms, prs=sampled.prs,
            rhos=sampled.rhos, appx_vol=sampled.appx_vol,
            skinning_mod=self.skinning_mod, renderable_pts=renderable_pts)

    def bake_for_rendering(self, renderable_pts) -> SkinnedPoints:
        return SkinnedPoints.from_skinning_mod(renderable_pts,
                                               self.skinning_mod)


def _linear_schedule(start, end, steps, count):
    """optax's ``linear_schedule(start, end, steps)`` at update ``count``,
    the count before the update increments it."""
    if steps <= 0:
        return end
    return start + (end - start) * min(count, steps) / steps


def _adam_step_fn(skin, training_pts, physics_points, appx_vol, generator,
                  num_samples, batch_size, num_steps, lr_start, lr_end,
                  le_coeff, lo_coeff):
    """The training step of :func:`_train_mlp` as a function of its index
    i → (elastic loss, ortho loss), each call one Adam step on ``skin``'s
    parameters.

    Step i draws from ``generator`` (:func:`losses._draw_batch`), blends
    the energies at i / num_steps and takes its learning rate from
    :func:`_linear_schedule` at i, as optax's ``adam(linear_schedule(...))``
    does; torch's schedulers step after the update and would be one step
    late."""
    yms, prs, rhos = physics_points.yms, physics_points.prs, \
        physics_points.rhos
    optimizer = torch.optim.Adam(skin.parameters(), lr=lr_start)
    h_learned = skin.layers[-1].out_features
    n = training_pts.shape[0]

    def step(i):
        for group in optimizer.param_groups:
            group["lr"] = _linear_schedule(lr_start, lr_end, num_steps, i)
        sample_indices, transforms = losses._draw_batch(
            generator, n, num_samples, batch_size, h_learned)
        le, lo = losses._evaluate_losses(
            skin, training_pts, yms, prs, rhos, i / num_steps, appx_vol,
            le_coeff, lo_coeff, sample_indices, transforms)
        optimizer.zero_grad(set_to_none=True)
        (le + lo).backward()
        optimizer.step()
        return le.detach(), lo.detach()

    return step


def _train_mlp(skin, training_pts, physics_points, appx_vol, generator,
               log_every, **kw):
    """``kw["num_steps"]`` Adam steps of :func:`_adam_step_fn` on
    ``skin``, in place; the losses are logged every ``log_every`` steps
    (the only reads back to the host)."""
    step = _adam_step_fn(skin, training_pts, physics_points, appx_vol,
                         generator, **kw)
    for i in range(kw["num_steps"]):
        le, lo = step(i)
        if i % log_every == 0:
            logger.info("Training step: %d, le: %f, lo: %f",
                        i, float(le), float(lo))
