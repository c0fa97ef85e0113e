"""Pluggable extrinsics parameterizations. Counterpart of
``kaolin_tpu/render/camera/extrinsics_backends.py``: a backend defines how
(R, t) map to the differentiable ``params`` and back. The two built-in
backends ("matrix_se3", "matrix_6dof_rotation") live in
:class:`~kaolin_tpu_torch.render.camera.extrinsics.CameraExtrinsics`;
backends registered here are consulted for any other name."""

import enum
from abc import ABC, abstractmethod

__all__ = ["ExtrinsicsRep", "register_backend", "get_backend",
           "ExtrinsicsParamsDefEnum"]

_BACKEND_REGISTRY = {}


class ExtrinsicsRep(ABC):
    """A camera-extrinsics parameterization. Subclass it and decorate the
    subclass with :func:`register_backend`."""

    @classmethod
    @abstractmethod
    def params_from_Rt(cls, R, t):
        """(C, 3, 3), (C, 3) → (C, P) parameters."""

    @classmethod
    @abstractmethod
    def R(cls, params):
        """(C, P) → (C, 3, 3)."""

    @classmethod
    @abstractmethod
    def t(cls, params):
        """(C, P) → (C, 3, 1)."""


def register_backend(name):
    """Class decorator registering an :class:`ExtrinsicsRep` under
    ``name``."""
    def wrap(cls):
        if not issubclass(cls, ExtrinsicsRep):
            raise TypeError("backend must subclass ExtrinsicsRep")
        _BACKEND_REGISTRY[name] = cls
        return cls
    return wrap


def get_backend(name):
    return _BACKEND_REGISTRY.get(name)


class ExtrinsicsParamsDefEnum(enum.IntEnum):
    """The slots every extrinsics backend exposes: the camera axes (R) and
    the translation (t)."""
    R = 0
    t = 1
