"""Simplicits objects: material points, baked skinning, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/training.py``: the point
containers and :class:`SimplicitsObject` with its rigid and analytic
constructors and its baking. Training an MLP skinning field
(``create_with_mlp``) and RKPM weights (``create_with_rkpm``) are not
ported yet (ROADMAP, Queue A 2b).
"""

import numpy as np
import torch

from kaolin_tpu_torch.physics.simplicits.network import SkinningModule

__all__ = [
    "PhysicsPoints",
    "SkinnedPoints",
    "SkinnedPhysicsPoints",
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
    """Physics points and a skinning weight field (analytic or, once
    training is ported, learned)."""

    def __init__(self, pts, yms, prs, rhos, appx_vol,
                 skinning_mod: SkinningModule):
        super().__init__(pts, yms, prs, rhos, appx_vol)
        self.skinning_mod = skinning_mod

    @classmethod
    def create_rigid(cls, physics_points: PhysicsPoints):
        """The constant handle alone: rigid and affine motion only."""
        skin = SkinningModule.from_function(
            lambda x: x.new_zeros((x.shape[0], 0)))
        return cls(physics_points.pts, physics_points.yms,
                   physics_points.prs, physics_points.rhos,
                   physics_points.appx_vol, skin)

    @classmethod
    def create_from_function(cls, physics_points: PhysicsPoints, fcn):
        """An analytic weight function of normalized points."""
        return cls(physics_points.pts, physics_points.yms,
                   physics_points.prs, physics_points.rhos,
                   physics_points.appx_vol,
                   SkinningModule.from_function(fcn))

    @classmethod
    def create_with_mlp(cls, *args, **kwargs):
        """Not ported yet: MLP training needs the losses and an Adam loop
        (ROADMAP, Queue A 2b)."""
        raise NotImplementedError(
            "create_with_mlp is not ported yet (ROADMAP Queue A 2b: "
            "Simplicits training)")

    @classmethod
    def create_with_rkpm(cls, *args, **kwargs):
        """Not ported yet: RKPM weights need farthest-point sampling
        (ROADMAP, Queue A 2b)."""
        raise NotImplementedError(
            "create_with_rkpm is not ported yet (ROADMAP Queue A 2b: "
            "Simplicits training)")

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
