"""Material I/O errors and the grouping of materials by name.

Counterpart of ``kaolin_tpu/io/materials.py``.
"""

import warnings
from collections.abc import Mapping

import numpy as np

from kaolin_tpu_torch.io.obj import (  # noqa: F401
    MaterialError,
    MaterialFileError,
    MaterialLoadError,
    MaterialNotFoundError,
)
from kaolin_tpu_torch.render.materials import PBRMaterial  # noqa: F401

__all__ = ["MaterialError", "MaterialFileError", "MaterialLoadError",
           "MaterialNotFoundError", "MaterialNotSupportedError",
           "MaterialWriteError", "PBRMaterial", "group_materials_by_name",
           "process_materials_and_assignments"]


class MaterialNotSupportedError(MaterialError):
    pass


class MaterialWriteError(MaterialError):
    pass


def _try_to_get_name(material):
    name = None
    if isinstance(material, Mapping):
        name = material.get("material_name")
    else:
        try:
            name = material.material_name
        except AttributeError:
            warnings.warn(f"Material {type(material)} had no material_name")
    return None if name == "" else name


def group_materials_by_name(materials_list, material_assignments):
    """Deduplicate materials by name → (materials in alphabetical order,
    unnamed last; the assignments remapped to it)."""
    material_indices = {}
    grouped = []
    assignments = (np.array(material_assignments)
                   if material_assignments is not None else None)
    orig = (np.array(material_assignments)
            if material_assignments is not None else None)
    for cur_idx, mat in enumerate(materials_list):
        name = _try_to_get_name(mat)
        if name in material_indices:
            new_idx = material_indices[name]
        else:
            new_idx = len(grouped)
            grouped.append(mat)
            if name is not None:
                material_indices[name] = new_idx
        if assignments is not None:
            assignments[orig == cur_idx] = new_idx
    order = sorted(range(len(grouped)),
                   key=lambda i: (_try_to_get_name(grouped[i]) is None,
                                  _try_to_get_name(grouped[i]) or ""))
    new_materials = [grouped[i] for i in order]
    if assignments is None:
        return new_materials, None
    out = assignments.copy()
    for new_idx, orig_idx in enumerate(order):
        out[assignments == orig_idx] = new_idx
    return new_materials, out


def _try_to_set_name(mat, name):
    if isinstance(mat, Mapping):
        mat["material_name"] = name
    else:
        try:
            mat.material_name = name
        except AttributeError as e:
            warnings.warn(f"Cannot set dummy material_name: {e}")


def process_materials_and_assignments(materials_dict,
                                      material_assignments_dict,
                                      error_handler, num_faces,
                                      error_context_str=""):
    """dict-style materials and per-material face ids or (start, end)
    rows → (material list sorted by name, per-face int16 assignment, −1
    where unassigned). A material referenced but absent goes to
    ``error_handler``; what it returns stands in for it."""
    missing = []
    for mat_name in list(material_assignments_dict.keys()):
        if mat_name not in materials_dict:
            dummy = error_handler(MaterialNotFoundError(
                f"'Material {mat_name}' not found, but referenced. "
                f"{error_context_str}"))
            if dummy is not None:
                _try_to_set_name(dummy, mat_name)
                materials_dict[mat_name] = dummy
            else:
                missing.append(mat_name)
    for mat_name in missing:
        del material_assignments_dict[mat_name]

    material_names = sorted(materials_dict.keys())
    materials = [materials_dict[n] for n in material_names]
    assignments = np.full((num_faces,), -1, dtype=np.int16)
    for name, values in material_assignments_dict.items():
        mat_idx = material_names.index(name)
        values = np.asarray(values)
        if values.ndim == 1:
            indices = values
        else:
            if values.ndim != 2 or values.shape[-1] != 2:
                raise ValueError(
                    f"Unexpected shape {values.shape} for material "
                    f"assignments for material {name}. {error_context_str}")
            indices = np.concatenate(
                [np.arange(values[r, 0], values[r, 1], dtype=np.int64)
                 for r in range(values.shape[0])]) if len(values) else \
                np.zeros((0,), np.int64)
        assignments[indices] = mat_idx
    return materials, assignments
