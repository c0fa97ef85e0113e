"""The port's data I/O (``kaolin_tpu_torch/io``: the INRIA 3DGS PLY,
``import_synthetic_view``, the dataset wrappers, ``CachedDataset`` and
``utils/bundled_data``) against kaolin_tpu's, on the CPU.

The 3DGS writer's file equals JAX's byte for byte and each package reads
the other's: the raw arrays equal, the activations (sigmoid, exp,
normalization) within 1e-6 relative. F30: JAX's ``CachedDataset`` over a
``KaolinDataset`` raises ``TypeError``; the port's caches it, and its
first and later reads are equal, in types too. ``num_workers=2`` spawns
its pool and writes the serial caches.
"""

import json
import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import kaolin_tpu.io as jio
import kaolin_tpu.io.dataset as jds
import kaolin_tpu_torch.io as tio
import kaolin_tpu_torch.io.dataset as tds
import kaolin_tpu_torch.utils.bundled_data as tbd
from kaolin_tpu_torch.utils.testing import contained_torch_equal
from tests.torch_io_parity import (
    PointsSource,
    assert_close,
    assert_meshes_equal,
    double_points,
    host,
)
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_RTOL = 1e-6


def _gaussians(n=300, degree=3, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    return dict(positions=rng.randn(n, 3).astype(np.float32),
                orientations=(q / np.linalg.norm(q, axis=1, keepdims=True))
                .astype(np.float32),
                scales=np.exp(rng.randn(n, 3) - 3).astype(np.float32),
                opacities=rng.uniform(0.01, 0.99, n).astype(np.float32),
                sh_coeff=rng.randn(n, (degree + 1) ** 2, 3).astype(
                    np.float32))


def _write_gaussians(pkg, path, g, tensors=False):
    conv = (lambda x: torch.from_numpy(x)) if tensors else (lambda x: x)
    pkg.ply.export_gaussiancloud(
        path, conv(g["positions"]), conv(g["orientations"]),
        conv(g["scales"]), conv(g["opacities"]), conv(g["sh_coeff"]))


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_gaussian_ply_matches_jax(degree, tmp_path):
    """The port's ``export_gaussiancloud`` (given tensors) writes JAX's
    bytes; each package reads the other's file: ``import_gaussians`` equal,
    ``import_gaussiancloud`` with its activations within 1e-6 relative and
    without them equal but the normalized quaternions (within 1e-6)."""
    g = _gaussians(degree=degree, seed=degree)
    _write_gaussians(jio, str(tmp_path / "j.ply"), g)
    _write_gaussians(tio, str(tmp_path / "t.ply"), g, tensors=True)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    with pytest.raises(RuntimeError):
        _write_gaussians(tio, str(tmp_path / "t.ply"), g)
    for src in ("j.ply", "t.ply"):
        path = str(tmp_path / src)
        raw_t = tio.ply.import_gaussians(path, device="cpu")
        raw_j = jio.ply.import_gaussians(path)
        assert raw_t.keys() == raw_j.keys()
        for k in raw_j:
            assert_close(raw_t[k], raw_j[k], what=k)
        for act in (True, False):
            got = tio.ply.import_gaussiancloud(path, apply_activations=act,
                                               device="cpu")
            want = jio.ply.import_gaussiancloud(path, apply_activations=act)
            for k in ("positions", "sh_coeff"):
                assert_close(getattr(got, k), getattr(want, k), what=k)
            for k in ("orientations", "scales", "opacities"):
                exact = k != "orientations" and not act
                np.testing.assert_allclose(
                    host(getattr(got, k)), host(getattr(want, k)),
                    rtol=0 if exact else ACT_RTOL, atol=0, err_msg=k)
    got = tio.import_gaussiancloud(str(tmp_path / "j.ply"), device="cpu")
    assert got.sh_degree == degree
    assert_close(got.positions, g["positions"])


def test_gaussian_scene_round_trip(tmp_path):
    """``examples/torch_asset_render.py``'s 3DGS path at 4,096 gaussians:
    after the transform, the second import's positions and SH equal the
    transformed cloud's bit for bit, its quaternions equal the transformed
    ones normalized (the import's rule) bit for bit and within 1e-6 of
    them, its opacities and scales within 1e-6 relative; the first import
    equals JAX's of the same file within 1e-6."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import torch_asset_render as ex
    finally:
        sys.path.pop(0)
    out = ex.gaussian_scene(str(tmp_path), 4096, "cpu")
    moved, back = out["moved"], out["reimported"]
    assert back.sh_coeff.shape == (4096, 16, 3)
    for k in ("positions", "sh_coeff"):
        assert torch.equal(getattr(back, k), getattr(moved, k)), k
    q = moved.orientations
    normalized = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                          keepdim=True),
                                 min=1e-12)
    assert torch.equal(back.orientations, normalized)
    for k in ("orientations", "opacities", "scales"):
        np.testing.assert_allclose(host(getattr(back, k)),
                                   host(getattr(moved, k)), rtol=ACT_RTOL,
                                   atol=0, err_msg=k)
    want = jio.import_gaussiancloud(out["paths"][0])
    for k in ("positions", "orientations", "scales", "opacities",
              "sh_coeff"):
        np.testing.assert_allclose(host(getattr(out["imported"], k)),
                                   host(getattr(want, k)), rtol=ACT_RTOL,
                                   atol=0, err_msg=k)


def test_pointcloud_export_matches_jax(tmp_path):
    """``export_pointcloud`` with normals and 0-255 colours: JAX's bytes,
    and ``import_pointcloud`` as JAX's."""
    rng = np.random.RandomState(3)
    pts, nrm = rng.randn(50, 3).astype(np.float32), rng.randn(50, 3)
    col = rng.randint(0, 256, (50, 3))
    jio.ply.export_pointcloud(str(tmp_path / "j.ply"), pts, col, nrm)
    tio.ply.export_pointcloud(str(tmp_path / "t.ply"), torch.from_numpy(pts),
                              torch.from_numpy(col), torch.from_numpy(nrm))
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    for g, w in zip(tio.ply.import_pointcloud(str(tmp_path / "t.ply"),
                                              device="cpu"),
                    jio.ply.import_pointcloud(str(tmp_path / "j.ply"))):
        assert_close(g, w)


def _synthetic_view(d, with_extras):
    rng = np.random.RandomState(2)
    Image.fromarray((rng.rand(8, 8, 4) * 255).astype(np.uint8)).save(
        os.path.join(d, "0_rgb.png"))
    if with_extras:
        Image.fromarray((rng.rand(8, 8, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, "0_normals.png"))
        np.save(os.path.join(d, "0_depth_linear.npy"),
                rng.rand(8, 8).astype(np.float32))
        np.save(os.path.join(d, "0_semantic.npy"),
                rng.randint(0, 5, (8, 8)).astype(np.int32))
    meta = {"asset_transforms": [[0, (np.eye(4) * 2).tolist()]],
            "camera_properties": {
                "tf_mat": rng.rand(4, 4).tolist(),
                "resolution": {"width": 16, "height": 8},
                "focal_length": 24.0, "horizontal_aperture": 20.955,
                "clipping_range": [0.01, 10000.0]},
            "bbox_2d_tight": [[1, 2, 3, 4]], "bbox_2d_loose": [[0, 1, 5, 6]]}
    with open(os.path.join(d, "0_metadata.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.mark.parametrize("with_extras", [True, False])
def test_import_synthetic_view_matches_jax(with_extras, tmp_path):
    """Every output of ``import_synthetic_view`` (the RGB of an RGBA PNG,
    normals, depth, semantic, a missing instance file, the metadata's
    transforms and projection, the boxes) as JAX's."""
    d = str(tmp_path)
    _synthetic_view(d, with_extras)
    kw = dict(rgb=True, depth_linear=True, semantic=True, instance=True,
              normals=True, bbox_2d_tight=True, bbox_2d_loose=True)
    got = tio.import_synthetic_view(d, 0, device="cpu", **kw)
    want = jio.import_synthetic_view(d, 0, **kw)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "metadata":
            assert got[k].keys() == w.keys()
            for m in w:
                if m == "clipping_range":
                    assert got[k][m] == w[m]
                else:
                    assert_close(got[k][m], w[m], ACT_RTOL, m)
        elif w is None or isinstance(w, list):
            assert got[k] == w, k
        else:
            assert_close(got[k], w, what=k)


# -- the dataset wrappers --------------------------------------------------
def _mesh_files(root, layout, ext, count=2):
    """OBJ or OFF meshes at ``layout.format(i=...)`` under ``root``."""
    from kaolin_tpu_torch.io import obj, off
    for i in range(count * 2):
        path = os.path.join(root, layout.format(c=("a", "b")[i % 2], i=i))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rng = np.random.RandomState(i)
        v = rng.rand(6, 3).astype(np.float32)
        f = rng.randint(0, 6, (4, 3))
        (obj if ext == "obj" else off).export_mesh(path, vertices=v,
                                                   faces=f)


@pytest.mark.parametrize("kind", ["ShapeNetV1", "ShapeNetV2", "ModelNet",
                                  "SHREC16"])
def test_datasets_match_jax(kind, tmp_path):
    """Each wrapper over a small tree: its length, paths, labels and every
    item's mesh as JAX's."""
    root = str(tmp_path)
    layout, ext, kw = {
        "ShapeNetV1": ("{c}/m{i}/model.obj", "obj", dict(split=0.5)),
        "ShapeNetV2": ("{c}/m{i}/models/model_normalized.obj", "obj",
                       dict(train=False, split=0.5)),
        "ModelNet": ("{c}/train/m{i}.off", "off", {}),
        "SHREC16": ("{c}/test/m{i}.obj", "obj", dict(split="test")),
    }[kind]
    _mesh_files(root, layout, ext)
    got = getattr(tio, kind)(root, device="cpu", **kw)
    want = getattr(jio, kind)(root, **kw)
    assert len(got) == len(want) > 0
    assert got.paths == want.paths
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for k in w:
            if k == "mesh":
                assert_meshes_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


class Squares(tds.KaolinDataset):
    """A KaolinDataset of points, with attributes."""

    def initialize(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_data(self, index):
        return {"points": torch.full((4, 3), float(index))}

    def get_attributes(self, index):
        return {"name": f"sq{index}", "index": index}


class JaxSquares(jds.KaolinDataset):
    initialize = Squares.initialize
    __len__ = Squares.__len__
    get_attributes = Squares.get_attributes

    def get_data(self, index):
        return {"points": np.full((4, 3), float(index), np.float32)}


def _types(tree):
    if isinstance(tree, dict):
        return {k: _types(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_types(v) for v in tree])
    return (type(tree).__name__, getattr(tree, "dtype", None),
            str(getattr(tree, "device", "")))


def test_cached_kaolin_dataset_f30(tmp_path):
    """F30. JAX's ``CachedDataset`` over a ``KaolinDataset`` (and a
    ``CombinationDataset``) raises ``TypeError`` at its first cached read;
    the port's caches it, and its first and later reads (and a new
    dataset's, from the cache) are equal, in types too; the cached pickle
    holds the namedtuple of numpy arrays."""
    jsrc = JaxSquares(3)
    with pytest.raises(TypeError):
        jds.CachedDataset(jsrc, preprocessing_transform=double_points,
                          cache_dir=str(tmp_path / "j"))[0]
    with pytest.raises(TypeError):
        jds.CachedDataset(jds.CombinationDataset(jsrc, jsrc),
                          preprocessing_transform=lambda x: x,
                          cache_dir=str(tmp_path / "jc"))[0]
    for name, src, fn in (
            ("kaolin", Squares(3), double_points),
            ("combination", tds.CombinationDataset(Squares(3), Squares(3)),
             lambda x: x)):
        cache = str(tmp_path / name)
        ds = tds.CachedDataset(src, preprocessing_transform=fn,
                               cache_dir=cache, device="cpu")
        first = [ds[i] for i in range(3)]
        later = [ds[i] for i in range(3)]
        fresh = tds.CachedDataset(src, preprocessing_transform=fn,
                                  cache_dir=cache, device="cpu")
        for a, b, c in zip(first, later, [fresh[i] for i in range(3)]):
            assert isinstance(a, tds.KaolinDatasetItem)
            assert _types(a) == _types(b) == _types(c)
            assert contained_torch_equal(a, b) and contained_torch_equal(a, c)
    assert torch.equal(first[2].data[0]["points"], torch.full((4, 3), 2.0))
    with open(os.path.join(str(tmp_path / "kaolin"), "item_00000002.pkl"),
              "rb") as f:
        cached = pickle.load(f)
    assert isinstance(cached, tds.KaolinDatasetItem)
    assert isinstance(cached.data["points"], np.ndarray)


def test_cached_dataset_matches_jax(tmp_path):
    """Over a dict source with a read-time transform: the port's items
    equal JAX's cached reads (as tensors on its device), with and without a
    cache; ``Cache`` memoizes as JAX's."""
    src = PointsSource(4)
    for cache in ("c", None):
        kw = dict(preprocessing_transform=double_points,
                  transform=lambda item: {**item, "seen": True})
        got = tds.CachedDataset(src, cache_dir=cache and str(tmp_path / "t"),
                                device="cpu", **kw)
        want = jds.CachedDataset(src, cache_dir=cache and str(tmp_path / "j"),
                                 **kw)
        for _ in range(2):
            for i in range(4):
                g, w = got[i], want[i]
                assert g["seen"] and g["name"] == str(w["name"])
                assert isinstance(g["points"], torch.Tensor)
                assert_close(g["points"], w["points"])
    calls = []
    tc = tds.Cache(lambda x: calls.append(x) or x * 3, str(tmp_path / "k"),
                   cache_key="v1")
    assert tc("a", 2) == 6 and tc("a", 5) == 6 and calls == [2]


def test_cached_dataset_pool_matches_serial(tmp_path):
    """``num_workers=2``: the spawned pool runs (no fallback warning), every
    cache is written in the constructor and equals the serial loop's; an
    unpicklable transform falls back to the serial loop with a warning, as
    JAX's."""
    src = PointsSource(6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pooled = tds.CachedDataset(src, double_points,
                                   cache_dir=str(tmp_path / "pool"),
                                   num_workers=2, device="cpu")
    serial = tds.CachedDataset(src, double_points,
                               cache_dir=str(tmp_path / "serial"),
                               device="cpu")
    for i in range(6):
        assert os.path.exists(pooled._cache_path(i))
        serial[i]
        with open(pooled._cache_path(i), "rb") as f, \
                open(serial._cache_path(i), "rb") as g:
            a, b = pickle.load(f), pickle.load(g)
        assert a.keys() == b.keys() and a["name"] == b["name"]
        np.testing.assert_array_equal(a["points"], b["points"])
    with pytest.warns(UserWarning, match="falling back to serial"):
        tds.CachedDataset(src, lambda item: item,
                          cache_dir=str(tmp_path / "fallback"),
                          num_workers=2, device="cpu")
    assert os.path.exists(os.path.join(str(tmp_path / "fallback"),
                                       "item_00000005.pkl"))


def test_processed_dataset_is_deprecated(tmp_path):
    with pytest.warns(DeprecationWarning):
        ds = tds.ProcessedDataset(PointsSource(2), double_points,
                                  cache_dir=str(tmp_path), device="cpu")
    assert len(ds) == 2


def test_bundled_data_offline(tmp_path, monkeypatch):
    """The registry's names, paths and checksums as JAX's; with the fetch
    patched to fail (nothing is downloaded), a missing dataset raises
    RuntimeError naming the URL, and files present with their MD5 sums are
    taken without a fetch."""
    import hashlib

    import kaolin_tpu.utils.bundled_data as jbd
    for name in ("SCANNED_TOYS_NAMES", "TENSOR_IR_NAMES",
                 "_TOYS_PLY_CHECKSUMS", "_TENSOR_IR_PLY_CHECKSUMS"):
        assert getattr(tbd, name) == getattr(jbd, name)
    assert os.path.relpath(tbd.BUNDLED_DATA_PATH, ROOT) == \
        os.path.relpath(jbd.BUNDLED_DATA_PATH, ROOT)
    fetched = []

    def offline(url, target):
        fetched.append(url)
        raise OSError("no network")

    monkeypatch.setattr(tbd, "_fetch", offline)
    monkeypatch.setattr(tbd, "SCANNED_TOYS_PATH", str(tmp_path / "toys"))
    monkeypatch.setattr(tbd, "TENSOR_IR_PATH", str(tmp_path / "ir"))
    for fn in (tbd.download_scanned_toys_dataset,
               tbd.download_tensor_ir_dataset):
        with pytest.raises(RuntimeError, match="Could not download"):
            fn()
    assert len(fetched) == 2
    (tmp_path / "x.ply").write_bytes(b"data")
    sums = {"x.ply": hashlib.md5(b"data").hexdigest()}
    tbd._download_if_needed("http://unused/x.zip", str(tmp_path), sums)
    assert len(fetched) == 2
    with pytest.raises(RuntimeError):
        tbd._download_if_needed("http://unused/x.zip", str(tmp_path),
                                {"x.ply": "0" * 32})
