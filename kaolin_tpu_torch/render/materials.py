"""Materials — USD-PreviewSurface-aligned PBR material container.

Counterpart of ``kaolin_tpu/render/materials.py``. Values are float32
tensors of shape (n,), textures tensors stored CHW with ``hwc()``/``chw()``
converters. A tensor keeps its device; an array or a number becomes a CPU
tensor. ``render_mesh`` moves what it samples to the mesh's device when it
renders, and keeps no copy.
"""

import numpy as np
import torch

__all__ = ["Material", "PBRMaterial", "random_material_colorspaces",
           "random_material_values",
           "random_material_textures"]

_VALUE_ATTRS = [
    "diffuse_color", "roughness_value", "metallic_value", "clearcoat_value",
    "clearcoat_roughness_value", "opacity_value", "opacity_threshold",
    "ior_value", "specular_color", "displacement_value", "transmittance_value",
]
_TEXTURE_ATTRS = [
    "diffuse_texture", "roughness_texture", "metallic_texture",
    "clearcoat_texture", "clearcoat_roughness_texture", "opacity_texture",
    "ior_texture", "specular_texture", "normals_texture",
    "displacement_texture", "transmittance_texture",
]
_COLORSPACE_ATTRS = [a.replace("_texture", "_colorspace")
                     for a in _TEXTURE_ATTRS]


def _tensor(data, dtype=None):
    if isinstance(data, torch.Tensor):
        return data if dtype is None else data.to(dtype)
    return torch.as_tensor(np.asarray(data), dtype=dtype)


def _to_1d(data):
    if data is None:
        return None
    return _tensor(data, torch.float32).reshape(-1)


class Material:
    """Abstract material base."""

    def __init__(self, name="", shader_name=""):
        self.material_name = name
        self.shader_name = shader_name


class PBRMaterial(Material):
    """PBR material aligned to USD Preview Surface."""

    def __init__(self, material_name="", shader_name="UsdPreviewSurface",
                 is_specular_workflow=False, **kwargs):
        super().__init__(material_name, shader_name)
        self.is_specular_workflow = is_specular_workflow
        for a in _VALUE_ATTRS:
            setattr(self, a, _to_1d(kwargs.pop(a, None)))
        for a in _TEXTURE_ATTRS:
            v = kwargs.pop(a, None)
            setattr(self, a, None if v is None else _tensor(v))
        for a in _COLORSPACE_ATTRS:
            setattr(self, a, kwargs.pop(a, "auto"))
        if kwargs:
            raise TypeError(f"unknown PBRMaterial attributes {sorted(kwargs)}")

    @classmethod
    def supported_texture_attributes(cls):
        return list(_TEXTURE_ATTRS)

    @classmethod
    def supported_tensor_attributes(cls):
        return list(_TEXTURE_ATTRS) + list(_VALUE_ATTRS)

    def get_attributes(self, only_tensors=False):
        """Names of set attributes."""
        names = (_VALUE_ATTRS + _TEXTURE_ATTRS if only_tensors else
                 _VALUE_ATTRS + _TEXTURE_ATTRS + _COLORSPACE_ATTRS
                 + ["is_specular_workflow", "material_name", "shader_name"])
        return [n for n in names if getattr(self, n, None) is not None]

    def _construct_apply(self, func):
        out = PBRMaterial(material_name=self.material_name,
                          shader_name=self.shader_name,
                          is_specular_workflow=self.is_specular_workflow)
        for a in _VALUE_ATTRS + _TEXTURE_ATTRS:
            v = getattr(self, a)
            setattr(out, a, None if v is None else
                    (func(v) if a in _TEXTURE_ATTRS else v))
        for a in _COLORSPACE_ATTRS:
            setattr(out, a, getattr(self, a))
        return out

    def hwc(self):
        """Textures CHW → HWC."""
        return self._construct_apply(
            lambda t: t.permute(1, 2, 0) if t.ndim == 3 else t)

    def chw(self):
        """Textures HWC → CHW."""
        return self._construct_apply(
            lambda t: t.permute(2, 0, 1) if t.ndim == 3 else t)

    def __repr__(self):
        return (f"PBRMaterial(name={self.material_name!r}, "
                f"attrs={self.get_attributes(only_tensors=True)})")


def _seed(key):
    """A seed from a ``torch.Generator``'s state: its first draw."""
    if key is None:
        return 0
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=key))


def random_material_values(key=None):
    """Random PBR scalar values (a testing convenience) from the
    ``torch.Generator`` ``key``; the same values for ``None`` every call."""
    rng = np.random.RandomState(_seed(key))
    return dict(
        diffuse_color=rng.rand(3).astype(np.float32),
        roughness_value=rng.rand(1).astype(np.float32),
        metallic_value=rng.rand(1).astype(np.float32),
    )


def random_material_textures(key=None, res=16):
    """Random diffuse (3, res, res) and roughness (1, res, res) textures
    from the ``torch.Generator`` ``key``."""
    rng = np.random.RandomState(_seed(key))
    return dict(
        diffuse_texture=rng.rand(3, res, res).astype(np.float32),
        roughness_texture=rng.rand(1, res, res).astype(np.float32),
    )


def random_material_colorspaces(key=None):
    """Random 'auto'/'raw' colorspace assignment for every PBR texture slot,
    from the ``torch.Generator`` ``key``."""
    import random as _random
    rng = _random.Random(None if key is None else _seed(key))
    slots = ["diffuse", "roughness", "metallic", "clearcoat",
             "clearcoat_roughness", "opacity", "ior", "specular", "normals",
             "displacement", "transmittance"]
    return {f"{s}_colorspace": rng.choice(["auto", "raw"]) for s in slots}
