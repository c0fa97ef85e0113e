"""SurfaceMesh — the central mesh attribute container.

Counterpart of ``kaolin_tpu/rep/surface_mesh.py``: an attribute container
with three batching strategies (NONE / FIXED / LIST), a lazy auto-compute
graph (face_vertices, face_normals, face_uvs, vertex_normals,
vertex_tangents, ...), batching conversion (``set_batching``,
``getattr_batched``), concatenation (``cat``, ``flatten``), sanity checks
(``check_sanity``) and a stored ``transform`` applied by
``as_transformed``.

Values are torch tensors (LIST batching holds python lists of them). A
tensor is kept as it is given, on its device, with its dtype and its
autograd history; an array or a nested list of numbers becomes a tensor of
its own dtype on the device of ``vertices`` (the CPU when ``vertices`` is
not a tensor). Integer attributes keep their dtype; index gathers cast to
``long`` inside. Auto-computed attributes are cached on access;
``allow_auto_compute=False`` disables that.

Setting an attribute drops every cached attribute computed from it,
directly or through others (``_DEPENDENTS``): after ``mesh.vertices = v``
the normals, tangents and face values are those of ``v``. The JAX package
drops only the attributes that list the new one directly among their
requirements, so its ``vertex_normals``, ``vertex_tangents`` and
``face_tangents`` stay those of the old geometry.

Attribute shapes (B batch, V verts, VN normals, U uvs, F faces, FSz
vertices/face)::

    attribute              NONE            FIXED              LIST
    vertices               V x 3           B x V x 3          [V_i x 3]
    faces                  F x FSz         F x FSz            [F_i x FSz_i]
    face_vertices          F x FSz x 3     B x F x FSz x 3    [...]
    normals                VN x 3          B x VN x 3         [VN_i x 3]
    face_normals_idx       F x FSz         B x F x FSz        [F_i x FSz_i]
    face_normals           F x FSz x 3     B x F x FSz x 3    [...]
    uvs                    U x 2           B x U x 2          [U_i x 2]
    face_uvs_idx           F x FSz         B x F x FSz        [F_i x FSz_i]
    face_uvs               F x FSz x 2     B x F x FSz x 2    [...]
    vertex_normals         V x 3           B x V x 3          [V_i x 3]
    vertex_tangents        V x 3           B x V x 3          [V_i x 3]
    vertex_colors          V x C           B x V x C          [V_i x C]
    vertex_features        V x C           B x V x C          [V_i x C_i]
    face_tangents          F x FSz x 3     B x F x FSz x 3    [...]
    face_colors            F x FSz x C     B x F x FSz x C    [...]
    face_features          F x FSz x C     B x F x FSz x C    [...]
    material_assignments   F               B x F              [F_i]
    transform              4 x 4           (B x) 4 x 4        (B x) 4 x 4
    materials              list            list of lists      list of lists

``faces`` is the only fixed-topology attribute under FIXED batching
(shared across the batch, stored unbatched). ``transform`` may be a single
(4, 4) matrix broadcast over the batch or one per element.
"""

from __future__ import annotations

import copy as _copymod
import enum
import logging

import numpy as np
import torch

from kaolin_tpu_torch.utils.numerics import clip

__all__ = ["SurfaceMesh"]

logger = logging.getLogger(__name__)

_FLOAT_ATTRS = [
    "vertices", "face_vertices", "normals", "face_normals", "vertex_normals",
    "uvs", "face_uvs", "vertex_tangents", "vertex_colors", "vertex_features",
    "face_tangents", "face_colors", "face_features", "transform",
]
_INT_ATTRS = ["faces", "face_normals_idx", "face_uvs_idx",
              "material_assignments"]
_TENSOR_ATTRS = _FLOAT_ATTRS + _INT_ATTRS
# constructor/table order
_ORDERED_ATTRS = [
    "vertices", "faces", "face_vertices", "normals", "face_normals_idx",
    "face_normals", "uvs", "face_uvs_idx", "face_uvs", "vertex_normals",
    "vertex_tangents", "vertex_colors", "vertex_features", "face_tangents",
    "face_colors", "face_features", "material_assignments", "transform",
]
_MISC_ATTRS = ["materials", "batching", "allow_auto_compute",
               "unset_attributes_return_none"]
_SETTINGS_ATTRS = ["allow_auto_compute", "unset_attributes_return_none"]
# from index attribute : to the indexed value attribute
_INDEXED_ATTRS = {"faces": "vertices", "face_normals_idx": "normals",
                  "face_uvs_idx": "uvs", "material_assignments": "materials"}
# the only attribute shared (unbatched) across a FIXED batch
_FIXED_TOPOLOGY_ATTRS = ["faces"]

# ways an attribute can be auto-computed, in priority order
_COMPUTABLE = {
    "vertex_normals": [["faces", "face_normals"]],
    "vertex_tangents": [["faces", "face_vertices", "face_uvs",
                         "vertex_normals"]],
    "vertex_colors": [["faces", "face_colors"]],
    "vertex_features": [["faces", "face_features"]],
    "face_vertices": [["faces", "vertices"]],
    "face_normals": [["normals", "face_normals_idx"],
                     ["vertex_normals", "faces"],
                     ["vertices", "faces"]],
    "face_uvs": [["uvs", "face_uvs_idx"]],
    "face_tangents": [["vertex_tangents", "faces"]],
    "face_colors": [["vertex_colors", "faces"]],
    "face_features": [["vertex_features", "faces"]],
}


def _dependents(name):
    """The computable attributes that some requirement set of
    ``_COMPUTABLE`` ties to ``name``, directly or through others."""
    out, frontier = set(), {name}
    while frontier:
        frontier = {d for d, reqs in _COMPUTABLE.items()
                    if d != name and d not in out
                    and any(a in r for r in reqs for a in frontier)}
        out |= frontier
    return out


# what setting an attribute drops from the cache
_DEPENDENTS = {a: _dependents(a) for a in _TENSOR_ATTRS}


class SurfaceMesh:
    """Batched surface mesh container with lazy attribute compute."""

    class Batching(str, enum.Enum):
        """Batching strategies supported by ``SurfaceMesh``."""
        NONE = "NONE"    #: a single unbatched mesh
        FIXED = "FIXED"  #: fixed-topology batch (shared ``faces``)
        LIST = "LIST"    #: list of meshes of any topology

    # -- static introspection --
    @staticmethod
    def supported_tensor_attributes():
        """All tensor attribute names, in canonical order."""
        return list(_ORDERED_ATTRS)

    @staticmethod
    def computable_attribute_requirements():
        """Auto-compute dependency table."""
        return {k: [list(r) for r in v] for k, v in _COMPUTABLE.items()}

    @staticmethod
    def assert_supported(attr):
        """Raise AttributeError for unknown attribute names."""
        if attr not in _TENSOR_ATTRS and attr not in _MISC_ATTRS:
            raise AttributeError(
                f'SurfaceMesh does not support attribute named "{attr}"')

    def __init__(self, vertices=None, faces=None,
                 batching=None, allow_auto_compute=True,
                 unset_attributes_return_none=True, strict_checks=True,
                 **kwargs):
        object.__setattr__(self, "_attrs", {})
        if batching is None:
            if isinstance(vertices, (list, tuple)):
                batching = SurfaceMesh.Batching.LIST
            elif vertices is not None and np.ndim(vertices) == 3:
                batching = SurfaceMesh.Batching.FIXED
            else:
                batching = SurfaceMesh.Batching.NONE
        object.__setattr__(self, "batching", SurfaceMesh.Batching(batching))
        object.__setattr__(self, "allow_auto_compute", allow_auto_compute)
        object.__setattr__(self, "unset_attributes_return_none",
                           unset_attributes_return_none)
        object.__setattr__(self, "materials", kwargs.pop("materials", None))
        if vertices is not None:
            self._attrs["vertices"] = self._wrap(vertices)
        if faces is not None:
            self._attrs["faces"] = self._wrap(faces)
        for k, v in kwargs.items():
            if k not in _TENSOR_ATTRS:
                raise TypeError(f"unknown SurfaceMesh attribute {k!r}")
            if v is not None:
                self._attrs[k] = self._wrap(v)
        if strict_checks and not self.check_sanity():
            raise ValueError(
                "Illegal inputs passed to SurfaceMesh constructor; check log")

    def _device(self):
        v = self._attrs.get("vertices")
        if isinstance(v, list):
            v = v[0] if v else None
        return v.device if isinstance(v, torch.Tensor) else None

    def _wrap(self, v):
        if isinstance(v, (list, tuple)):
            return [self._wrap(x) for x in v]
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v), device=self._device())

    # -- attribute protocol --
    def __getattr__(self, name):
        if name.startswith("_") or name in _MISC_ATTRS:
            raise AttributeError(name)
        if name in self._attrs:
            return self._attrs[name]
        if name in _COMPUTABLE and self.allow_auto_compute:
            val = self._compute_attribute(name)
            if val is not None:
                self._attrs[name] = val
                return val
        if name in _TENSOR_ATTRS:
            if self.unset_attributes_return_none:
                return None
            raise AttributeError(f"attribute {name} is not set")
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in _TENSOR_ATTRS:
            if value is None:
                self._attrs.pop(name, None)
            else:
                self._attrs[name] = self._wrap(value)
            for derived in _DEPENDENTS[name]:
                self._attrs.pop(derived, None)
        else:
            object.__setattr__(self, name, value)

    def has_attribute(self, name):
        """True when ``name`` is set (computed values count once cached)."""
        return name in self._attrs or (name in _MISC_ATTRS
                                       and getattr(self, name) is not None)

    def has_or_can_compute_attribute(self, name, _visited=None):
        """True when ``name`` is set or probably computable."""
        return self.has_attribute(name) or \
            self.probably_can_compute_attribute(name, _visited)

    def probably_can_compute_attribute(self, name, _visited=None):
        """True when some requirement set of ``name`` is available.
        ``_visited`` breaks dependency cycles (face_normals ↔
        vertex_normals)."""
        if name not in _COMPUTABLE:
            return False
        visited = set() if _visited is None else _visited
        if name in visited:
            return False
        visited = visited | {name}
        return any(all(self.has_or_can_compute_attribute(r, visited)
                       for r in req if r != name)
                   for req in _COMPUTABLE[name])

    def get_attributes(self, only_tensors=False):
        """Names of currently-set attributes."""
        out = [a for a in _ORDERED_ATTRS if a in self._attrs]
        if not only_tensors and self.materials is not None:
            out.append("materials")
        return out

    def get_attribute(self, attr):
        """Get without auto-compute; None (or raise if
        ``not unset_attributes_return_none``) when unset."""
        SurfaceMesh.assert_supported(attr)
        if attr in self._attrs:
            return self._attrs[attr]
        if attr in _MISC_ATTRS:
            return object.__getattribute__(self, attr)
        if self.unset_attributes_return_none:
            return None
        raise AttributeError(f'Attribute "{attr}" has not been set')

    def get_or_compute_attribute(self, attr, should_cache=None):
        """Get, auto-computing if needed, with explicit cache control
        (``should_cache=False`` computes without storing)."""
        SurfaceMesh.assert_supported(attr)
        if attr in self._attrs:
            return self._attrs[attr]
        if attr not in _COMPUTABLE:
            return self.get_attribute(attr)
        val = self._compute_attribute(attr)
        if val is None:
            if self.unset_attributes_return_none:
                return None
            raise AttributeError(
                f'Attribute "{attr}" is not set and cannot be computed')
        if should_cache or should_cache is None:
            self._attrs[attr] = val
        return val

    def ensure_indexed_attribute(self, attr, should_cache=None):
        """Build ``(values, index)`` for 'normals' or 'uvs' from the
        corresponding ``face_{attr}`` when the indexed form is absent.

        Returns ``(values, index)`` or ``(None, None)``."""
        if attr not in ("normals", "uvs"):
            raise ValueError(
                'ensure_indexed_attribute only supports "normals" and "uvs"')
        face_val_attr = f"face_{attr}"
        face_idx_attr = f"face_{attr}_idx"
        if self.has_attribute(attr) and self.has_attribute(face_idx_attr):
            return self.get_attribute(attr), self.get_attribute(face_idx_attr)
        if not (self.has_attribute(face_val_attr)
                and not self.has_attribute(attr)
                and not self.has_attribute(face_idx_attr)):
            return None, None
        from kaolin_tpu_torch.ops.mesh import unindex_vertices_by_faces

        fv = self._attrs[face_val_attr]
        if self.batching == SurfaceMesh.Batching.LIST:
            res = [unindex_vertices_by_faces(x) for x in fv]
            val = [r[0] for r in res]
            idx = [r[1] for r in res]
        else:
            val, idx = unindex_vertices_by_faces(fv)
            if self.batching == SurfaceMesh.Batching.FIXED:
                idx = idx[None].expand((fv.shape[0],) + tuple(idx.shape))
        if should_cache or should_cache is None:
            self._attrs[attr] = val
            self._attrs[face_idx_attr] = idx
        return val, idx

    # -- auto-compute --
    def _compute_attribute(self, name):
        in_progress = self.__dict__.get("_computing")
        if in_progress is None:
            in_progress = set()
            object.__setattr__(self, "_computing", in_progress)
        if name in in_progress:
            return None  # cycle (e.g. face_normals ↔ vertex_normals)
        in_progress.add(name)
        try:
            for req in _COMPUTABLE[name]:
                vals = []
                for r in req:
                    v = getattr(self, r, None)
                    if v is None:
                        break
                    vals.append(v)
                else:
                    return getattr(self, f"_compute_{name}")(*vals)
            return None
        finally:
            in_progress.discard(name)

    def _map(self, fn, *attrs):
        """Apply fn per item under the batching strategy."""
        if self.batching == SurfaceMesh.Batching.LIST:
            n = len(attrs[0])
            return [fn(*[a[i] for a in attrs]) for i in range(n)]
        return fn(*attrs)

    @staticmethod
    def _gather(values, idx):
        """values (V,C)|(B,V,C) indexed by idx (F,FSz)|(B,F,FSz)."""
        idx = idx.to(device=values.device, dtype=torch.long)
        if values.ndim == 3 and idx.ndim == 3:   # both batched
            b = torch.arange(values.shape[0], device=values.device)
            return values[b[:, None, None], idx]
        if values.ndim == 3:                     # batched values, shared idx
            return values[:, idx]
        return values[idx]

    def _compute_face_vertices(self, faces, vertices):
        return self._map(self._gather, vertices, faces)

    def _compute_face_uvs(self, uvs, face_uvs_idx):
        def one(u, fi):
            return self._gather(u, fi.clamp(min=0))
        return self._map(one, uvs, face_uvs_idx)

    def _compute_face_normals(self, a, b):
        # three signatures by priority
        for req in _COMPUTABLE["face_normals"]:
            if all(getattr(self, r, None) is not None for r in req):
                kind = req[0]
                break
        if kind == "normals":  # normals + face_normals_idx
            return self._compute_face_uvs(self.normals, self.face_normals_idx)
        if kind == "vertex_normals":
            return self._compute_face_vertices(self.faces, self.vertex_normals)
        # flat normals from vertices + faces, repeated per corner
        from kaolin_tpu_torch.ops.mesh import face_normals as fnormals

        def one(v, f):
            f = f.to(device=v.device, dtype=torch.long)
            fv = v[:, f] if v.ndim == 3 else v[f][None]
            n = fnormals(fv, unit=True)
            out = n[:, :, None, :].expand(tuple(n.shape[:2])
                                          + (f.shape[-1], 3))
            return out if v.ndim == 3 else out[0]
        return self._map(one, self.vertices, self.faces)

    def _compute_vertex_normals(self, faces, face_normals):
        from kaolin_tpu_torch.ops.mesh import compute_vertex_normals

        def one(f, fn):
            batched = fn.ndim == 4
            fn_ = fn if batched else fn[None]
            f_ = f[0] if f.ndim == 3 else f
            out = compute_vertex_normals(f_, fn_,
                                         num_vertices=self._num_verts(f_))
            return out if batched else out[0]
        return self._map(one, faces, face_normals)

    def _num_verts(self, faces):
        v = self._attrs.get("vertices")
        if v is None:
            return int(faces.max()) + 1
        if isinstance(v, list):
            return None
        return v.shape[-2]

    def _compute_vertex_colors(self, faces, face_colors):
        return self._compute_vertex_normals(faces, face_colors)

    def _compute_vertex_features(self, faces, face_features):
        return self._compute_vertex_normals(faces, face_features)

    def _compute_vertex_tangents(self, faces, face_vertices, face_uvs,
                                 vertex_normals):
        from kaolin_tpu_torch.ops.mesh import vertex_tangents as vt

        def one(f, fv, fu, vn):
            f_ = f[0] if f.ndim == 3 else f
            if fv.ndim == 4:
                return torch.stack([vt(f_, fv[i], fu[i], vn[i])
                                    for i in range(fv.shape[0])])
            return vt(f_, fv, fu, vn)
        return self._map(one, faces, face_vertices, face_uvs, vertex_normals)

    def _compute_face_tangents(self, vertex_tangents, faces):
        return self._compute_face_vertices(faces, vertex_tangents)

    def _compute_face_colors(self, vertex_colors, faces):
        return self._compute_face_vertices(faces, vertex_colors)

    def _compute_face_features(self, vertex_features, faces):
        return self._compute_face_vertices(faces, vertex_features)

    # -- sanity --
    @staticmethod
    def _expected_shape(name, batching, batchsize=None, numverts=None,
                        numfaces=None, facesize=None, numnormals=None,
                        numuvs=None):
        """Expected shape as a list with None for free dims."""
        B, V, VN, F, U, FSz = (batchsize, numverts, numnormals, numfaces,
                               numuvs, facesize)
        Any = None
        shapes = {
            "vertices": [V, 3], "normals": [VN, 3], "uvs": [U, 2],
            "vertex_normals": [V, 3], "vertex_tangents": [V, 3],
            "vertex_colors": [V, Any], "vertex_features": [V, Any],
            "face_normals": [F, FSz, 3], "face_uvs": [F, FSz, 2],
            "face_vertices": [F, FSz, 3], "face_tangents": [F, FSz, 3],
            "face_colors": [F, FSz, Any], "face_features": [F, FSz, Any],
            "faces": [F, FSz], "material_assignments": [F],
            "face_normals_idx": [F, FSz], "face_uvs_idx": [F, FSz],
            "transform": [4, 4],
        }
        if name not in shapes:
            raise NotImplementedError(
                f"Cannot get expected shape for attribute {name}")
        if batching == SurfaceMesh.Batching.FIXED \
                and name not in _FIXED_TOPOLOGY_ATTRS and name != "transform":
            return [B] + shapes[name]
        return shapes[name]

    @staticmethod
    def _shape_matches(shape, expected):
        if len(shape) != len(expected):
            return False
        return all(e is None or not isinstance(e, int) or s == e
                   for s, e in zip(shape, expected))

    def check_sanity(self):
        """Check tensor shapes are consistent for the current batching;
        logs inconsistencies.

        Return: (bool) True if sane."""
        known = {"batchsize": len(self) if "vertices" in self._attrs else None}
        fixed = self.batching == SurfaceMesh.Batching.FIXED
        for attr, key in (("vertices", "numverts"), ("normals", "numnormals"),
                          ("uvs", "numuvs")):
            v = self._attrs.get(attr)
            if v is not None and not isinstance(v, list) and v.numel() > 0:
                known[key] = v.shape[1 if fixed else 0]
        f = self._attrs.get("faces")
        if f is not None and not isinstance(f, list) and f.numel() > 0 \
                and self.batching in (SurfaceMesh.Batching.NONE,
                                      SurfaceMesh.Batching.FIXED):
            known["numfaces"], known["facesize"] = f.shape[0], f.shape[1]

        res = True
        for attr, val in self._attrs.items():
            if isinstance(val, list):
                if self.batching != SurfaceMesh.Batching.LIST:
                    logger.error("attribute %s is a list under %s batching",
                                 attr, self.batching.value)
                    res = False
                    continue
                exp = SurfaceMesh._expected_shape(
                    attr, SurfaceMesh.Batching.NONE)
                for i, x in enumerate(val):
                    if attr == "transform":
                        continue
                    if not SurfaceMesh._shape_matches(x.shape, exp):
                        logger.error(
                            "attribute %s[%d] has shape %s, expected %s",
                            attr, i, tuple(x.shape), exp)
                        res = False
                continue
            if attr == "transform":
                ok = SurfaceMesh._shape_matches(val.shape, [4, 4]) or (
                    self.batching != SurfaceMesh.Batching.NONE
                    and SurfaceMesh._shape_matches(val.shape,
                                                   [len(self), 4, 4]))
                if not ok:
                    logger.error("transform has shape %s, expected (4, 4)"
                                 " or (B, 4, 4)", tuple(val.shape))
                    res = False
                continue
            if self.batching == SurfaceMesh.Batching.LIST:
                continue  # tensors invalid under LIST handled above
            exp = SurfaceMesh._expected_shape(attr, self.batching, **known)
            ok = SurfaceMesh._shape_matches(val.shape, exp)
            if not ok and attr in _INT_ATTRS and fixed:
                # index arrays may also be stored shared (unbatched) across a
                # FIXED batch; the compute functions accept both forms
                ok = SurfaceMesh._shape_matches(
                    val.shape, SurfaceMesh._expected_shape(
                        attr, SurfaceMesh.Batching.NONE, **known))
            if not ok:
                logger.error("attribute %s has shape %s, expected %s",
                             attr, tuple(val.shape), exp)
                res = False
        return res

    def is_triangular(self):
        """True iff every mesh in the batch is triangular."""
        f = self._attrs.get("faces")
        if f is None:
            return False
        if isinstance(f, list):
            return all(x.shape[-1] == 3 for x in f)
        return f.shape[-1] == 3

    # -- batching --
    def __len__(self):
        v = self._attrs.get("vertices")
        if self.batching == SurfaceMesh.Batching.NONE:
            return 1
        if self.batching == SurfaceMesh.Batching.LIST:
            return len(v)
        return v.shape[0]

    @staticmethod
    def convert_attribute_batching(val, from_batching, to_batching,
                                   is_tensor=True, fixed_topology=False,
                                   batch_size=None):
        """Convert a value between batching strategies (NONE → [val] /
        val[None]; LIST → stack; FIXED → unstack; fixed-topology values stay
        shared)."""
        from_batching = SurfaceMesh.Batching(from_batching)
        to_batching = SurfaceMesh.Batching(to_batching)
        B = SurfaceMesh.Batching
        guess = None
        if from_batching == B.LIST:
            guess = len(val)
        elif from_batching == B.NONE:
            guess = 1
        elif from_batching == B.FIXED:
            if is_tensor and not fixed_topology:
                guess = val.shape[0]
            elif not is_tensor:
                guess = len(val)
        if batch_size is not None:
            if guess is not None and batch_size != guess:
                raise ValueError(
                    f"Provided batch size {batch_size} disagrees with value "
                    f"{guess} guessed from input")
        else:
            batch_size = 1 if guess is None else guess

        if from_batching == to_batching or batch_size == 0:
            return val
        if not is_tensor:
            # materials & other non-tensors: lists for LIST/FIXED batching
            if to_batching == B.NONE:
                if batch_size != 1:
                    raise ValueError(
                        "Cannot return unbatched non-tensor attribute from "
                        f"batch of length {batch_size}")
                return val[0]
            if from_batching == B.NONE:
                return [val]
            return val
        if to_batching == B.NONE:
            if batch_size != 1:
                raise ValueError(
                    "Cannot return unbatched tensor attribute from batch of "
                    f"length {batch_size}")
            if from_batching == B.LIST:
                return val[0]
            return val if fixed_topology else val.squeeze(0)
        if to_batching == B.FIXED:
            if from_batching == B.NONE:
                return val if fixed_topology else val[None]
            # LIST → FIXED
            if fixed_topology:
                for i in range(1, batch_size):
                    if not (val[0].shape == val[i].shape
                            and bool(torch.equal(val[0], val[i]))):
                        raise ValueError("Fixed topology attribute must be "
                                         "equivalent for all meshes")
                return val[0]
            return torch.stack(val)
        # to LIST
        if from_batching == B.NONE:
            return [val]
        if fixed_topology:
            return [val for _ in range(batch_size)]
        return [val[i] for i in range(batch_size)]

    def getattr_batched(self, attr, batching):
        """Like ``getattr`` but converts the value to the requested batching
        strategy before returning."""
        val = getattr(self, attr)
        batching = SurfaceMesh.Batching(batching)
        if self.batching == batching or val is None:
            return val
        is_material = attr == "materials"
        is_tensor = attr in _TENSOR_ATTRS
        if not is_material and not is_tensor:
            return val
        # transform stays (4, 4) / (B, 4, 4) under every strategy
        if attr == "transform":
            if batching == SurfaceMesh.Batching.NONE:
                if len(self) != 1:
                    raise ValueError("Cannot return unbatched transform from "
                                     f"batch of length {len(self)}")
                return val if val.ndim == 2 else val[0]
            return val
        return SurfaceMesh.convert_attribute_batching(
            val, from_batching=self.batching, to_batching=batching,
            is_tensor=is_tensor,
            fixed_topology=attr in _FIXED_TOPOLOGY_ATTRS,
            batch_size=len(self))

    def set_batching(self, batching, skip_errors=False):
        """Convert in place to another batching strategy; returns self.
        Unsupported: to NONE from a batch of >1 meshes; to FIXED from a LIST
        with differing topologies."""
        batching = SurfaceMesh.Batching(batching)
        if self.batching == batching or len(self) == 0:
            return self
        if batching == SurfaceMesh.Batching.NONE and len(self) != 1:
            raise ValueError(
                f"Cannot create an unbatched mesh from {len(self)} meshes")
        new_attrs = {}
        for attr in self.get_attributes(only_tensors=True):
            try:
                new_attrs[attr] = self.getattr_batched(attr, batching)
            except Exception as e:
                if skip_errors and attr not in ("vertices", "faces"):
                    logger.error("Failed to convert attribute %s: %s",
                                 attr, e)
                    new_attrs[attr] = None
                else:
                    raise ValueError(
                        f"Cannot convert {attr} to batching {batching}: {e}")
        materials = self.materials
        if materials is not None:
            materials = SurfaceMesh.convert_attribute_batching(
                materials, self.batching, batching, is_tensor=False,
                batch_size=len(self))
        for attr, val in new_attrs.items():
            if val is None:
                self._attrs.pop(attr, None)
            else:
                self._attrs[attr] = val
        object.__setattr__(self, "materials", materials)
        object.__setattr__(self, "batching", batching)
        return self

    def to_batched(self):
        """NONE → FIXED with batch dim 1, in place; returns self."""
        return self.set_batching(SurfaceMesh.Batching.FIXED)

    @classmethod
    def cat(cls, meshes, fixed_topology=True, skip_errors=False):
        """Concatenate meshes/batches into a FIXED (if ``fixed_topology``) or
        LIST batched mesh. Only attributes present (or computable) in all
        inputs are preserved; ``transform`` is batched, never applied (use
        :meth:`flatten` for that)."""
        meshes = list(meshes)
        target = cls.Batching.FIXED if fixed_topology else cls.Batching.LIST
        # attributes present in all inputs (auto-computing when possible)
        joint = None
        for m in meshes:
            attrs = set(m.get_attributes(only_tensors=True))
            for a in _COMPUTABLE:
                if a not in attrs and m.allow_auto_compute \
                        and m.probably_can_compute_attribute(a):
                    attrs.add(a)
            joint = attrs if joint is None else joint & attrs
        kwargs = {}
        for k in joint:
            vals = []
            ok = True
            for m in meshes:
                v = getattr(m, k) if k in _COMPUTABLE else m._attrs.get(k)
                if v is None:
                    ok = False
                    break
                try:
                    vals.append(m.getattr_batched(k, cls.Batching.LIST))
                except Exception:
                    if skip_errors:
                        ok = False
                        break
                    raise
            if not ok:
                continue
            flat = []
            for v in vals:
                flat.extend(v) if isinstance(v, list) else flat.append(v)
            if k == "transform":
                try:
                    kwargs[k] = torch.stack(
                        [x if x.ndim == 2 else x[0] for x in flat])
                except Exception:
                    if not skip_errors:
                        raise
                continue
            if fixed_topology:
                try:
                    if k in _FIXED_TOPOLOGY_ATTRS:
                        # all inputs must actually share this topology
                        for other in flat[1:]:
                            if other.shape != flat[0].shape or \
                                    not bool(torch.equal(other, flat[0])):
                                raise ValueError(
                                    f"fixed_topology=True but inputs differ "
                                    f"in '{k}' — use fixed_topology=False")
                        kwargs[k] = flat[0]
                    else:
                        kwargs[k] = torch.stack(flat)
                except Exception as e:
                    if skip_errors and k not in ("vertices", "faces"):
                        continue
                    raise ValueError(f"Cannot cat attribute {k}: {e}")
            else:
                kwargs[k] = flat
        mats = [m.materials for m in meshes]
        materials = None
        if all(x is not None for x in mats):
            materials = []
            for m, x in zip(meshes, mats):
                if m.batching == cls.Batching.NONE:
                    materials.append(x)
                else:
                    materials.extend(x)
        return cls(batching=target, strict_checks=False, materials=materials,
                   **kwargs)

    @classmethod
    def flatten(cls, meshes, skip_errors=False):
        """Flatten meshes into ONE world-space mesh: applies each input's
        stored ``transform`` (via :meth:`as_transformed`), concatenates
        geometry, and book-keeps indexed attributes (``faces``,
        ``face_normals_idx``, ``face_uvs_idx``, ``material_assignments``) by
        offsetting indices into the concatenated value arrays."""
        meshes = [m.as_transformed() for m in meshes]
        mesh = cls.cat(meshes, fixed_topology=False, skip_errors=skip_errors)
        if len(mesh) == 1:
            mesh.set_batching(cls.Batching.NONE)
            return mesh
        _attrs = set(mesh.get_attributes(only_tensors=True))
        _attrs.discard("transform")  # already applied
        args = {}

        def _cat(values, name):
            try:
                return torch.cat(values, dim=0)
            except Exception as e:
                if skip_errors:
                    logger.error("Cannot flatten attribute %s: %s", name, e)
                    return None
                raise ValueError(f"Cannot flatten attribute {name}: {e}")

        materials = mesh.materials
        for idx_attr, val_attr in _INDEXED_ATTRS.items():
            val_list = None
            if val_attr == "materials":
                if materials is not None:
                    counts = [len(x) for x in materials]
            elif val_attr in _attrs:
                val_list = getattr(mesh, val_attr)
                _attrs.discard(val_attr)
                counts = [x.shape[0] for x in val_list]
            if idx_attr in _attrs:
                idx_list = list(getattr(mesh, idx_attr))
                _attrs.discard(idx_attr)
                if (val_attr == "materials" and materials is not None) \
                        or (val_attr != "materials" and val_list is not None):
                    start = 0
                    for i in range(len(idx_list)):
                        idx_list[i] = idx_list[i] + start
                        start += counts[i]
                cat_idx = _cat(idx_list, idx_attr)
                if cat_idx is not None:
                    args[idx_attr] = cat_idx
            if val_attr != "materials" and val_list is not None:
                cat_val = _cat(val_list, val_attr)
                if cat_val is not None:
                    args[val_attr] = cat_val
        if materials is not None:
            flat_mats = []
            for x in materials:
                flat_mats.extend(x)
            args["materials"] = flat_mats
        for attr in list(_attrs):
            cat_val = _cat(getattr(mesh, attr), attr)
            if cat_val is not None:
                args[attr] = cat_val
        return cls(strict_checks=False, **args)

    def __getitem__(self, idx):
        """Extract one mesh of the batch as an unbatched-like mesh (NONE
        batching returns self)."""
        if idx > len(self) - 1:
            raise IndexError(f"Out of bound index {idx} for mesh batch of "
                             f"length {len(self)}")
        if self.batching == SurfaceMesh.Batching.NONE:
            return self
        args = {"allow_auto_compute": self.allow_auto_compute,
                "unset_attributes_return_none":
                    self.unset_attributes_return_none}
        if self.materials is not None:
            args["materials"] = self.materials[idx]
        for attr, val in self._attrs.items():
            if attr == "transform":
                args[attr] = val if val.ndim == 2 else val[idx]
            elif self.batching == SurfaceMesh.Batching.LIST:
                args[attr] = val[idx]
            elif attr in _FIXED_TOPOLOGY_ATTRS:
                args[attr] = val
            else:
                args[attr] = val[idx]
        return SurfaceMesh(strict_checks=False, **args)

    # -- conversion / copies --
    def _apply(self, fn, attributes=None):
        names = attributes if attributes is not None else list(self._attrs)
        for k in names:
            v = self._attrs.get(k)
            if v is not None:
                self._attrs[k] = ([fn(x) for x in v] if isinstance(v, list)
                                  else fn(v))
        return self

    def float_tensors_to(self, dtype):
        """Cast the float attributes to ``dtype``, in place; returns self."""
        return self._apply(lambda x: x.to(dtype),
                           [k for k in self._attrs if k in _FLOAT_ATTRS])

    def detach(self, attributes=None):
        """Detach (selected) attributes from autograd, in place; returns
        self."""
        return self._apply(lambda x: x.detach(), attributes)

    def to(self, device, attributes=None):
        """Move (selected) attributes to ``device``, in place; returns
        self."""
        return self._apply(lambda x: x.to(device), attributes)

    def __copy__(self):
        """Shallow copy: the tensors are shared."""
        out = object.__new__(SurfaceMesh)
        object.__setattr__(out, "_attrs",
                           {k: (list(v) if isinstance(v, list) else v)
                            for k, v in self._attrs.items()})
        for a in _MISC_ATTRS:
            object.__setattr__(out, a, getattr(self, a))
        return out

    def __deepcopy__(self, memo):
        out = self.__copy__()
        if self.materials is not None:
            object.__setattr__(out, "materials",
                               _copymod.deepcopy(self.materials, memo))
        return out

    def copy(self):
        """Convenience shallow copy."""
        return self.__copy__()

    def as_transformed(self, transform=None):
        """New mesh with a 4x4 (or (B, 4, 4)) affine applied in world space.

        With no argument, applies and clears the mesh's stored
        :attr:`transform` (returns ``self`` when none is stored). Positions
        transform by M (with homogeneous divide); normals
        (``normals``/``vertex_normals``/``face_normals``) by the
        inverse-transpose of the linear part, re-normalized; tangents by the
        linear part, re-normalized. Derived ``face_vertices`` is cleared for
        lazy recompute."""
        if transform is None:
            transform = self._attrs.get("transform")
            if transform is None:
                return self
        verts = self._attrs["vertices"]
        ref = verts[0] if isinstance(verts, list) else verts
        m = torch.as_tensor(transform if isinstance(transform, torch.Tensor)
                            else np.asarray(transform),
                            dtype=ref.dtype, device=ref.device)
        lin = m[..., :3, :3]
        inv_lin = torch.linalg.inv(lin)

        def _per_elem(mat, i):
            return mat if mat.ndim == 2 else mat[i]

        def apply_pos(verts, mat):
            vh = torch.cat([verts, torch.ones_like(verts[..., :1])], -1)
            if mat.ndim == 3 and verts.ndim == 3:
                out = torch.einsum("bvk,bjk->bvj", vh, mat)
            else:
                out = vh @ mat.transpose(-1, -2)
            return out[..., :3] / out[..., 3:4]

        def _bc(mat3, vec):
            while mat3.ndim < vec.ndim:
                mat3 = mat3[..., None, :, :]
            return mat3

        def unit(out):
            return out / clip(torch.linalg.vector_norm(out, dim=-1,
                                                       keepdim=True), 1e-12)

        def apply_normal(vec, mat_inv):
            return unit(vec @ _bc(mat_inv, vec))

        def apply_tangent(vec, mat_lin):
            return unit(vec @ _bc(mat_lin, vec).transpose(-1, -2))

        out = self.__copy__()
        normal_attrs = ("normals", "vertex_normals", "face_normals")
        tangent_attrs = ("vertex_tangents", "face_tangents")
        if self.batching == SurfaceMesh.Batching.LIST:
            out._attrs["vertices"] = [
                apply_pos(v, _per_elem(m, i))
                for i, v in enumerate(self._attrs["vertices"])]
            for a in normal_attrs:
                if a in self._attrs:
                    out._attrs[a] = [
                        apply_normal(v, torch.linalg.inv(
                            _per_elem(m, i)[:3, :3]))
                        for i, v in enumerate(self._attrs[a])]
            for a in tangent_attrs:
                if a in self._attrs:
                    out._attrs[a] = [
                        apply_tangent(v, _per_elem(m, i)[:3, :3])
                        for i, v in enumerate(self._attrs[a])]
        else:
            out._attrs["vertices"] = apply_pos(self._attrs["vertices"], m)
            for a in normal_attrs:
                if a in self._attrs:
                    out._attrs[a] = apply_normal(self._attrs[a], inv_lin)
            for a in tangent_attrs:
                if a in self._attrs:
                    out._attrs[a] = apply_tangent(self._attrs[a], lin)
        out._attrs.pop("face_vertices", None)
        out._attrs.pop("transform", None)
        return out

    # -- printing --
    @classmethod
    def attribute_info_string(cls, batching):
        """Expected attribute shapes for a batching strategy, one per
        line."""
        batching = cls.Batching(batching)
        if batching == cls.Batching.LIST:
            names = dict(batchsize="B", numverts="V_i", numfaces="F_i",
                         facesize="FSz_i", numnormals="VN_i", numuvs="U_i")
        else:
            names = dict(batchsize="B", numverts="V", numfaces="F",
                         facesize="FSz", numnormals="VN", numuvs="U")
        res = [f"Expected SurfaceMesh contents for batching strategy "
               f"{batching.value}"]
        for attr in _ORDERED_ATTRS:
            shape = cls._expected_shape(attr, batching, **names)
            kind = "int" if attr in _INT_ATTRS else "float"
            shape_str = " x ".join("Any" if s is None else str(s)
                                   for s in shape)
            if batching == cls.Batching.LIST:
                res.append(f"{attr:>22}: [torch {kind} tensors] of shapes "
                           f"[{shape_str}]")
            else:
                res.append(f"{attr:>22}: (torch {kind} tensor)  of shape "
                           f"{shape_str}")
        res.append(f"{'materials':>22}: non-tensor attribute")
        return "\n".join(res)

    def describe_attribute(self, name, print_stats=False, detailed=False):
        """Informative one-or-multi-line description of an attribute."""
        SurfaceMesh.assert_supported(name)
        if not self.has_attribute(name):
            return "None"
        from kaolin_tpu_torch.utils.log import tensor_info

        if name == "materials":
            val = self.materials
            if self.batching == SurfaceMesh.Batching.NONE:
                return f"{'materials':>22}: list of length {len(val)}"
            items = [f"{i:>25}: list of length {len(x)}"
                     for i, x in enumerate(val)]
            return "\n".join([f"{'materials':>22}: ["] + items
                             + ["{:>25}".format("]")])
        val = self._attrs.get(name)
        if val is None:
            return f"{name:>22}: {getattr(self, name)}"
        if isinstance(val, list):
            items = [tensor_info(x, name=f"{i:>25}", print_stats=print_stats,
                                 detailed=detailed) for i, x in enumerate(val)]
            return "\n".join([f"{name:>22}: ["] + items
                             + ["{:>25}".format("]")])
        return tensor_info(val, name=f"{name:>22}", print_stats=print_stats,
                           detailed=detailed)

    def to_string(self, print_stats=False, detailed=False):
        """Multi-line summary of set attributes (+ what can be
        computed)."""
        res = [f"SurfaceMesh object with batching strategy "
               f"{self.batching.value}"]
        for attr in self.get_attributes(only_tensors=True):
            res.append(self.describe_attribute(attr, print_stats=print_stats,
                                               detailed=detailed))
        if self.materials is not None:
            res.append(self.describe_attribute("materials"))
        for attr, reqs in _COMPUTABLE.items():
            if attr in self._attrs:
                continue
            if self.probably_can_compute_attribute(attr):
                res.append(f"{attr:>22}: if possible, computed on access "
                           "from: "
                           + " or ".join("(" + ", ".join(r) + ")"
                                         for r in reqs))
        return "\n".join(res)

    def as_dict(self, only_tensors=False):
        """Currently-set attributes as a dict (raw values, no
        auto-compute)."""
        return {a: (self.materials if a == "materials" else self._attrs[a])
                for a in self.get_attributes(only_tensors=only_tensors)}

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        attrs = ", ".join(sorted(self._attrs.keys()))
        return (f"SurfaceMesh(batching={self.batching.value}, "
                f"len={len(self)}, attrs=[{attrs}])")
