"""nvdiffrast context management — API-compatibility stubs.

Counterpart of ``kaolin_tpu/render/mesh/nvdiffrast_context.py``. The
reference caches one nvdiffrast context per device for its nvdiffrast
rasterization backend. The port has no nvdiffrast backend: its rasterizer
is :func:`kaolin_tpu_torch.render.mesh.rasterize`, so these entry points
report nvdiffrast absent.
"""

__all__ = ["nvdiffrast_is_available", "default_nvdiffrast_context",
           "set_default_nvdiffrast_context"]

_CONTEXTS = {}


def nvdiffrast_is_available():
    """False: the port has no nvdiffrast backend."""
    return False


def default_nvdiffrast_context(device=None, raise_error=True):
    """The context stored for ``device``; without one, raise (or return
    None when ``raise_error=False``)."""
    ctx = _CONTEXTS.get(device)
    if ctx is not None:
        return ctx
    if raise_error:
        raise RuntimeError(
            "nvdiffrast is not available; use "
            "kaolin_tpu_torch.render.mesh.rasterize instead.")
    return None


def set_default_nvdiffrast_context(context, device=None):
    """Store a user-provided context object (for tests / future backends)."""
    _CONTEXTS[device] = context
    return context
