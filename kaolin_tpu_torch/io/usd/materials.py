"""USD material I/O manager — extensible shader reader/writer registry.

Counterpart of ``kaolin_tpu/io/usd/materials.py`` (reference
``kaolin/io/usd/materials.py:190``, ``UsdMaterialIoManager``): maps shader
names (the Shader prim's ``info:id`` token) to reader/writer callables so
USD import/export can support custom shaders beyond the built-in
``UsdPreviewSurface``.

Where the reference's callables operate on pxr ``UsdShade.Shader`` objects,
here readers receive ``(file_path, scene_path, time)`` against the
self-contained USDA backend and writers receive
``(material, stage, scene_path, time, write_texture_by_basename_fn)`` —
the same dataflow, pxr-free. ``read_material(..., device=...)`` passes
``device`` on to the reader (the built-in one's tensors land on the CUDA
device unless the CPU is named); a reader registered without a ``device``
argument is called as in the JAX package.
"""

import warnings

from kaolin_tpu_torch.io.usd.core import (
    _parse_usda,
    _read_usd_text,
    _scan_prims,
    read_usd_preview_surface,
    write_usd_preview_surface,
)

__all__ = ["UsdMaterialIoManager", "MaterialManager", "MaterialLoadError",
           "MaterialNotFoundError"]


class MaterialLoadError(Exception):
    """Raised when a material fails to parse. Ref (MaterialLoadError)."""


class MaterialNotFoundError(Exception):
    """Raised when no material/shader prim matches. Ref."""


def _shader_matches(prim, scene_path):
    """Does this Shader prim belong to ``scene_path``? Matches the prim's
    own path, or a Shader child under that path (the standard
    Material/Shader layout)."""
    if scene_path is None:
        return True
    path = prim.get("path", "")
    return path == scene_path or path.startswith(scene_path + "/") \
        or prim["name"] == scene_path.split("/")[-1]


def _shader_id(file_path, scene_path=None):
    """The info:id token of the (selected) Shader prim, or None."""
    import re
    for prim in _parse_usda(file_path):
        if prim["type"] != "Shader":
            continue
        if not _shader_matches(prim, scene_path):
            continue
        m = re.search(r'info:id\s*=\s*"([^"]+)"', prim["body"])
        if m:
            return m.group(1)
    return None


class UsdMaterialIoManager:
    """Registry of shader readers/writers keyed by shader name. Ref :190.

    Default registrations: ``UsdPreviewSurface`` in both directions."""

    _usd_readers = {}
    _usd_writers = {}

    @classmethod
    def register_usd_reader(cls, shader_name, reader_fn):
        """Register ``reader_fn(file_path, scene_path, time) -> material``
        for a shader name. Ref :210."""
        if shader_name in cls._usd_readers:
            warnings.warn(f"Shader {shader_name} is already registered. "
                          "Overwriting previous definition.", stacklevel=2)
        if not callable(reader_fn):
            raise TypeError("reader_fn must be callable")
        cls._usd_readers[shader_name] = reader_fn

    @classmethod
    def register_usd_writer(cls, shader_name, writer_fn):
        """Register ``writer_fn(material, stage, scene_path, time,
        write_texture_by_basename_fn) -> prim`` for a shader name.
        Ref :224."""
        if shader_name in cls._usd_writers:
            warnings.warn(f"Shader {shader_name} is already registered. "
                          "Overwriting previous definition.", stacklevel=2)
        if not callable(writer_fn):
            raise TypeError("writer_fn must be callable")
        cls._usd_writers[shader_name] = writer_fn

    @classmethod
    def read_material(cls, file_path, scene_path=None, time=None,
                      device=None):
        """Read a material by dispatching on the Shader prim's ``info:id``;
        unknown shaders fall back to the raw parameter dict. Ref :242.
        ``device``, when given, is passed on to the reader."""
        shader = _shader_id(file_path, scene_path)
        if shader is None:
            raise MaterialNotFoundError(
                f"no Shader prim found in {file_path}")
        reader = cls._usd_readers.get(shader)
        if reader is None:
            warnings.warn(
                f"No registered reader for shader {shader!r}; returning raw "
                "shader parameters.", stacklevel=2)
            return cls._raw_shader_params(file_path, scene_path)
        if device is not None:
            return reader(file_path, scene_path, time, device=device)
        return reader(file_path, scene_path, time)

    @classmethod
    def write_material(cls, material, stage, scene_path, time=None,
                       write_texture_by_basename_fn=None,
                       shader_name="UsdPreviewSurface"):
        """Write a material with the writer registered for ``shader_name``.
        Ref :285."""
        writer = cls._usd_writers.get(shader_name)
        if writer is None:
            raise MaterialLoadError(
                f"no registered writer for shader {shader_name!r}")
        return writer(material, stage, scene_path, time,
                      write_texture_by_basename_fn)

    @staticmethod
    def _raw_shader_params(file_path, scene_path=None):
        """dict of ``inputs:*`` attribute strings of the Shader prim (a
        binary layer's arrays as text too, not as placeholders)."""
        import re
        for prim in _scan_prims(_read_usd_text(file_path)):
            if prim["type"] != "Shader":
                continue
            if not _shader_matches(prim, scene_path):
                continue
            return dict(re.findall(r"inputs:([\w:]+)\s*=\s*([^\n]+)",
                                   prim["body"]))
        return {}


def _preview_surface_reader(file_path, scene_path, time, device=None):
    return read_usd_preview_surface(file_path, scene_path, time,
                                    device=device)


def _preview_surface_writer(material, stage, scene_path, time,
                            write_texture_by_basename_fn):
    return write_usd_preview_surface(
        material, stage, scene_path,
        write_texture_by_basename_fn=write_texture_by_basename_fn, time=time)


UsdMaterialIoManager._usd_readers["UsdPreviewSurface"] = \
    _preview_surface_reader
UsdMaterialIoManager._usd_writers["UsdPreviewSurface"] = \
    _preview_surface_writer

# reference alias (kaolin.io.usd.materials.MaterialManager deprecated name)
MaterialManager = UsdMaterialIoManager
