"""Shared pieces of the kaolin_tpu_torch I/O parity tests
(``test_torch_io_*.py``): mesh and material comparisons, and the
preprocessing transforms that spawned dataset workers import (this module
imports neither jax nor kaolin_tpu, so a worker starts quickly)."""

import numpy as np
import torch


def host(x):
    """A torch tensor, a JAX array or an array-like → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol=0.0, what=""):
    """Equal arrays (``rtol`` 0) or within ``rtol`` of max|want|; integer
    arrays compare by value whatever their widths."""
    got, want = host(got), host(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rtol == 0.0 or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                   err_msg=what)


def assert_materials_equal(port, ref, rtol=0.0):
    """Materials attribute by attribute: raw MTL dicts key by key, PBR
    materials through ``pbr_material_from_jax``."""
    from kaolin_tpu_torch.render import materials as tm
    from kaolin_tpu_torch.utils import pbr_material_from_jax

    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(r, dict):
            assert set(p) == set(r), (sorted(p), sorted(r))
            for k, v in r.items():
                if k == "material_name":
                    assert p[k] == v
                else:
                    assert_close(p[k], v, rtol, k)
            continue
        want = pbr_material_from_jax(r)
        assert p.get_attributes() == want.get_attributes(), (
            p.get_attributes(), want.get_attributes())
        for a in ("material_name", "shader_name", "is_specular_workflow",
                  *tm._COLORSPACE_ATTRS):
            assert getattr(p, a) == getattr(want, a), a
        for a in p.get_attributes(only_tensors=True):
            assert_close(getattr(p, a), getattr(want, a), rtol, a)


def assert_meshes_equal(port, ref, rtol=0.0, rtol_attrs=(), extra=()):
    """Every tensor attribute the JAX mesh has set, equal in the port's
    mesh (or within ``rtol`` of its max|x| for ``rtol_attrs``); the port
    sets no other but ``extra``; the materials as
    :func:`assert_materials_equal`."""
    names = set(ref.get_attributes(only_tensors=True))
    assert set(port.get_attributes(only_tensors=True)) == names | set(extra)
    for a in names:
        assert_close(port.get_attribute(a), ref.get_attribute(a),
                     rtol if a in rtol_attrs else 0.0, a)
    assert_materials_equal(port.materials, ref.materials, rtol)


def double_points(item):
    """A preprocessing transform: the item's points times 2 (a
    namedtuple's data field when the item is one)."""
    if isinstance(item, tuple):
        return type(item)(data=double_points(item.data),
                          attributes=item.attributes)
    return {**item, "points": item["points"] * 2}


class PointsSource:
    """A picklable source of ``n`` items {"points" (8, 3) float32,
    "name"}, seeded by the index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        rng = np.random.RandomState(index)
        return {"points": torch.from_numpy(rng.rand(8, 3).astype(
            np.float32)), "name": f"item{index}"}
