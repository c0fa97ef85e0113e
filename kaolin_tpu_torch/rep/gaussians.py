"""Point-sample and 3D-gaussian-splat containers.

Counterpart of ``kaolin_tpu/rep/gaussians.py`` (reference
``kaolin/rep/gaussians.py``, PointSamples :41, GaussianSplatModel :537):
per-point attribute containers with boolean-mask get and set, ``cat``,
canonical transforms and the SH-degree helpers. Attributes are stored
after activation, as in the reference (:639). Every tensor stays on the
device of ``positions``; an array is taken as a CPU tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaolin_tpu_torch.rep.tensor_container import TensorContainerBase

__all__ = ["PointSamples", "GaussianSplatModel"]


def _tensor(x, device=None):
    """A tensor as it is (moved to ``device`` if given), an array-like as a
    tensor of its own dtype."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _mask_tensor(mask, n, device):
    """A boolean (n,) mask (array or tensor) as a tensor on ``device``; the
    reference's checks (rep/gaussians.py:409-414)."""
    m = mask if isinstance(mask, torch.Tensor) else torch.as_tensor(
        np.asarray(mask))
    if m.dtype != torch.bool:
        raise TypeError(f"Mask must be boolean, got {m.dtype}")
    if m.ndim != 1 or m.shape[0] != n:
        raise ValueError(f"Mask length {tuple(m.shape)} does not match "
                         f"number of points {n}")
    return m.to(device)


class PointSamples(TensorContainerBase):
    """Generic per-point container: positions (N, 3) + optional features
    (N, D) + optional canonical 4x4 transform. Ref :41."""

    @classmethod
    def class_tensor_attributes(cls):
        return ["positions", "features", "transform"]

    @classmethod
    def class_other_attributes(cls):
        return []

    @classmethod
    def class_point_attributes(cls):
        return ["positions", "features"]

    def __init__(self, positions, features=None, transform=None,
                 strict_checks=True):
        self.positions = _tensor(positions)
        device = self.positions.device
        self.features = None if features is None else _tensor(features,
                                                               device)
        self.transform = None if transform is None else _tensor(transform,
                                                                device)
        if strict_checks:
            assert self.positions.ndim == 2 and self.positions.shape[1] == 3

    def __len__(self):
        return self.positions.shape[0]

    # -- masked indexing (ref :400, :429) --
    def __getitem__(self, mask):
        mask = _mask_tensor(mask, len(self), self.positions.device)
        kwargs = {}
        for a in self.class_point_attributes():
            v = getattr(self, a, None)
            kwargs[a] = None if v is None else v[mask]
        for a in self.class_tensor_attributes():
            if a not in self.class_point_attributes():
                kwargs[a] = getattr(self, a, None)
        for a in self.class_other_attributes():
            kwargs[a] = getattr(self, a, None)
        return type(self)(strict_checks=False,
                          **{k: v for k, v in kwargs.items() if v is not None
                             or k in self.class_point_attributes()})

    def __setitem__(self, mask, value):
        """Write ``value``'s point attributes at the masked rows, into new
        tensors (as JAX's ``.at[].set``): tensors shared with another
        container are left as they were."""
        assert isinstance(value, type(self))
        mask = _mask_tensor(mask, len(self), self.positions.device)
        for a in self.class_point_attributes():
            v = getattr(self, a, None)
            vv = getattr(value, a, None)
            if v is not None and vv is not None:
                v = v.clone()
                v[mask] = vv.to(v.device, v.dtype)
                setattr(self, a, v)

    # -- concatenation (ref :369) --
    @classmethod
    def cat(cls, models, skip_errors=False, **kwargs):
        """Concatenate along the point dimension. Any stored ``transform``
        is baked (``as_transformed``) before concatenation — the result
        always has ``transform=None`` (ref :383-384)."""
        if len(models) == 0:
            raise ValueError("cat requires at least one model")
        models = [m.as_transformed() if m.transform is not None else m
                  for m in models]
        if len(models) == 1:
            return models[0]
        out_kwargs = {}
        for a in cls.class_point_attributes():
            vals = [getattr(m, a, None) for m in models]
            if all(v is not None for v in vals):
                out_kwargs[a] = torch.cat(vals, dim=0)
            elif not skip_errors and any(v is not None for v in vals):
                raise ValueError(f"attribute {a} set on some models only")
        for a in cls.class_other_attributes():
            out_kwargs[a] = getattr(models[0], a, None)
        return cls(strict_checks=False, **out_kwargs)

    # -- transforms (ref :490, :510) --
    def _combined_canonical_transform(self, input_transform=None):
        p = self.positions
        t = (torch.eye(4, dtype=p.dtype, device=p.device)
             if self.transform is None else self.transform)
        if input_transform is not None:
            t = _tensor(input_transform, p.device) @ t
        return t

    def as_transformed(self, additional_transform=None):
        """Bake transform into positions → new container with no transform.
        Ref :510."""
        t = self._combined_canonical_transform(additional_transform)
        ph = torch.cat([self.positions,
                        torch.ones_like(self.positions[:, :1])], dim=1)
        new_pos = (ph @ t.T)[:, :3]
        return type(self)(positions=new_pos, features=self.features,
                          strict_checks=False)

    def describe_attribute(self, attr, **kwargs):
        v = getattr(self, attr, None)
        if v is None:
            return f"{attr}: unset"
        return f"{attr}: {tuple(v.shape)} {v.dtype}"

    def __repr__(self):
        return (f"{type(self).__name__}(num_points={len(self)}, "
                f"attrs={self.get_attributes(only_tensors=True)})")


class GaussianSplatModel(PointSamples):
    """3D gaussian splats: positions, orientations (wxyz unit quats), scales,
    opacities, sh_coeff (N, S, 3), optional features/transform. Ref :537.
    Unset attributes default to float32 identities on the positions'
    device."""

    @classmethod
    def class_tensor_attributes(cls):
        return ["positions", "orientations", "scales", "opacities",
                "sh_coeff", "features", "transform"]

    @classmethod
    def class_other_attributes(cls):
        return ["sh_degree"]

    @classmethod
    def class_point_attributes(cls):
        return ["positions", "orientations", "scales", "opacities",
                "sh_coeff", "features"]

    def __init__(self, positions, orientations=None, scales=None,
                 opacities=None, sh_coeff=None, features=None, transform=None,
                 sh_degree=None, strict_checks=True):
        super().__init__(positions, features=features, transform=transform,
                         strict_checks=strict_checks)
        n = self.positions.shape[0]
        device = self.positions.device
        if orientations is None:
            orientations = torch.zeros((n, 4), device=device)
            orientations[:, 0] = 1.0
        self.orientations = _tensor(orientations, device)
        self.scales = (_tensor(scales, device) if scales is not None
                       else torch.ones((n, 3), device=device))
        self.opacities = (_tensor(opacities, device).reshape(n)
                          if opacities is not None
                          else torch.ones((n,), device=device))
        self.sh_coeff = (_tensor(sh_coeff, device) if sh_coeff is not None
                         else torch.zeros((n, 1, 3), device=device))
        if sh_degree is None:
            sh_degree = self.compute_sh_degree(self.sh_coeff.shape[1])
        self.sh_degree = sh_degree
        if strict_checks:
            assert tuple(self.orientations.shape) == (n, 4)
            assert tuple(self.scales.shape) == (n, 3)
            assert self.sh_coeff.ndim == 3 and self.sh_coeff.shape[2] == 3

    @classmethod
    def compute_sh_degree(cls, num_sh_coeff):
        """(deg+1)² coeffs → deg. Ref :714."""
        deg = math.isqrt(num_sh_coeff) - 1
        if (deg + 1) ** 2 != num_sh_coeff:
            raise ValueError(f"{num_sh_coeff} is not a valid SH coeff count")
        return deg

    @classmethod
    def compute_num_sh_coeff(cls, sh_degree):
        """Ref :731."""
        return (sh_degree + 1) ** 2

    @classmethod
    def from_gaussian_dict(cls, d, activated=True):
        """Build from an INRIA ply dict (``positions``, ``rotations``,
        ``scales``, ``opacities``, ``sh_coeffs``): applies the sigmoid and
        exp activations unless ``activated`` is False."""
        ops = _tensor(d["opacities"]).reshape(-1)
        scales = _tensor(d["scales"])
        if activated:
            # INRIA checkpoints store logit opacity and log scales
            ops = 1.0 / (1.0 + torch.exp(-ops))
            scales = torch.exp(scales)
        rots = _tensor(d["rotations"])
        rots = rots / torch.clamp(
            torch.linalg.vector_norm(rots, dim=-1, keepdim=True), min=1e-12)
        return cls(positions=d["positions"], orientations=rots, scales=scales,
                   opacities=ops, sh_coeff=d["sh_coeffs"])

    def as_transformed(self, additional_transform=None):
        """Bake the canonical transform into all gaussian parameters
        (positions, orientations, scales, SH). Ref :762."""
        from kaolin_tpu_torch.ops.gaussians.transforms import (
            transform_gaussians,
        )
        t = self._combined_canonical_transform(additional_transform)
        pos, orient, scales, sh = transform_gaussians(
            self.positions, self.orientations, self.scales, t,
            sh_coeff=self.sh_coeff)
        return GaussianSplatModel(
            positions=pos, orientations=orient, scales=scales,
            opacities=self.opacities, sh_coeff=sh, features=self.features,
            sh_degree=self.sh_degree, strict_checks=False)
