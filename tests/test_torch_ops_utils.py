"""The port's remaining ops and utilities (``ops/gcn.py``, ``ops/random.py``,
``ops/coords.py``, ``ops/reduction.py``, ``utils/testing.py``,
``utils/env_vars.py``) against kaolin_tpu's, on the CPU.

``GraphConv`` with JAX's weights carried across (``graph_conv_from_jax``):
dense and COO adjacency, with and without the self layer, at B = 2, values
within 1e-5 relative and gradients within 1e-5 of max|g|. ``ops.random``
holds contracts, not values (torch's generator is not JAX's): shapes,
dtypes, ranges, integer bounds with ``high`` included, and one generator
seed giving one set of draws; ``random_spc_octrees`` equals JAX's
``unbatched_points_to_octree`` on the same points, where JAX's own
``random_spc_octrees`` raises (F31).
"""

import enum
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.ops.batch as jbatch
import kaolin_tpu.ops.coords as jcoords
import kaolin_tpu.ops.gcn as jgcn
import kaolin_tpu.ops.random as jrandom
import kaolin_tpu.utils.env_vars as jenv
import kaolin_tpu.utils.testing as jtesting
import kaolin_tpu_torch.ops.coords as tcoords
import kaolin_tpu_torch.ops.gcn as tgcn
import kaolin_tpu_torch.ops.random as trandom
import kaolin_tpu_torch.ops.reduction as treduction
import kaolin_tpu_torch.utils.env_vars as tenv
import kaolin_tpu_torch.utils.testing as ttesting
from kaolin_tpu_torch.utils import graph_conv_from_jax
from tests.torch_io_parity import assert_close
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

RTOL, GRAD_TOL = 1e-5, 1e-5


# -- GraphConv -------------------------------------------------------------
def _graph(n=12, seed=0):
    """A random graph of ``n`` nodes with self loops → (dense (n, n)
    float32, rows, cols)."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n, n) < 0.3).astype(np.float32)
    dense[np.arange(n), np.arange(n)] = 1.0
    dense *= rng.uniform(0.5, 2.0, (n, n)).astype(np.float32)
    rows, cols = np.nonzero(dense)
    return dense, rows, cols


def _adjacency(kind, dense, rows, cols, pkg):
    if kind == "dense":
        return jnp.asarray(dense) if pkg == "jax" else torch.from_numpy(dense)
    idx = np.stack([rows, cols]).astype(np.int32)
    vals = dense[rows, cols]
    if pkg == "jax":
        return jnp.asarray(idx), jnp.asarray(vals), dense.shape
    return torch.from_numpy(idx), torch.from_numpy(vals), dense.shape


@pytest.mark.parametrize("kind", ["dense", "coo"])
@pytest.mark.parametrize("self_layer,bias", [(True, True), (False, True),
                                             (True, False)])
@pytest.mark.parametrize("normalize", [True, False])
def test_graph_conv_matches_jax(kind, self_layer, bias, normalize):
    """Forward within 1e-5 of max|x|; the gradients of sum(out * cot) in
    every parameter and the features within 1e-5 of max|g|."""
    dense, rows, cols = _graph()
    layer = jgcn.GraphConv(5, 7, self_layer=self_layer, bias=bias)
    params = layer.init(jax.random.PRNGKey(3))
    if bias:   # non-zero biases, so their gradients and terms show
        params = {k: (v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype)
                      if k.startswith("b") else v) for k, v in params.items()}
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 12, 5).astype(np.float32)
    cot = rng.randn(2, 12, 7).astype(np.float32)
    jadj = _adjacency(kind, dense, rows, cols, "jax")

    def loss(p, x):
        return jnp.sum(layer.apply(p, x, jadj, normalize) * cot)

    want = layer.apply(params, jnp.asarray(feat), jadj, normalize)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feat))

    conv = graph_conv_from_jax(params)
    assert sorted(n for n, _ in conv.named_parameters()) == sorted(params)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = conv(x, _adjacency(kind, dense, rows, cols, "torch"),
               normalize_adj=normalize)
    assert_close(out, want, RTOL)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, p in conv.named_parameters():
        assert_close(p.grad, gp[name], GRAD_TOL, name)
    assert_close(x.grad, gx, GRAD_TOL, "features")


def test_sparse_ops_match_jax():
    """``sparse_bmm`` and ``normalize_adj`` (dense and COO) as JAX's."""
    dense, rows, cols = _graph(9, seed=4)
    x = np.random.RandomState(2).randn(3, 9, 4).astype(np.float32)
    jadj = _adjacency("coo", dense, rows, cols, "jax")
    tadj = _adjacency("coo", dense, rows, cols, "torch")
    assert_close(tgcn.sparse_bmm(tadj, torch.from_numpy(x)),
                 jgcn.sparse_bmm(jadj, jnp.asarray(x)), RTOL)
    assert_close(tgcn.normalize_adj(tadj)[1], jgcn.normalize_adj(jadj)[1],
                 RTOL)
    assert_close(tgcn.normalize_adj(torch.from_numpy(dense)),
                 jgcn.normalize_adj(jnp.asarray(dense)), RTOL)


def test_graph_conv_init_contract():
    """A new layer: ``w`` and ``w_self`` (in, out) within ±1/√in, the
    biases zeros, on the generator's device; one seed, one layer."""
    a = tgcn.GraphConv(16, 8, key=torch.Generator().manual_seed(5))
    b = tgcn.GraphConv(16, 8, key=torch.Generator().manual_seed(5))
    for name in ("w", "w_self"):
        w = getattr(a, name)
        assert w.shape == (16, 8) and float(w.detach().abs().max()) <= 0.25
        assert torch.equal(w, getattr(b, name))
    assert not a.b.any() and not a.b_self.any()
    c = tgcn.GraphConv(16, 8, self_layer=False, bias=False, device="cpu")
    assert c.w_self is None and c.b is None
    assert [n for n, _ in c.named_parameters()] == ["w"]


# -- ops.random ------------------------------------------------------------
def test_manual_seed_and_state():
    """``manual_seed`` seeds Python's, numpy's and torch's generators and
    returns a seeded ``torch.Generator``; ``get_state``/``set_state`` bring
    all three back."""
    g = trandom.manual_seed(7, device="cpu")
    first = (random.random(), np.random.rand(), float(torch.rand(1)),
             float(torch.rand(1, generator=g)))
    g = trandom.manual_seed(7, device="cpu")
    assert (random.random(), np.random.rand(), float(torch.rand(1)),
            float(torch.rand(1, generator=g))) == first
    state = trandom.get_state()
    draws = (random.random(), np.random.rand(), float(torch.rand(1)))
    trandom.set_state(state)
    assert (random.random(), np.random.rand(), float(torch.rand(1))) == draws
    trandom.manual_seed(3, random_seed=4, numpy_seed=5, device="cpu")
    r, n = random.random(), np.random.rand()
    random.seed(4)
    np.random.seed(5)
    assert (random.random(), np.random.rand()) == (r, n)


def test_random_shape_per_tensor_matches_jax():
    """Python's ``random`` draws the shapes: the same seed, JAX's
    shapes."""
    random.seed(11)
    got = trandom.random_shape_per_tensor(6, [1, 2], [5, 9])
    random.seed(11)
    want = jrandom.random_shape_per_tensor(6, [1, 2], [5, 9])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        trandom.random_shape_per_tensor(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.int32, torch.uint8])
def test_random_tensor_contract(dtype):
    """Shape and dtype as asked; floats in [low, high]; integers in [low,
    high] with both ends drawn; one seed, one tensor; without a key the
    draws follow Python's ``random``."""
    low, high = (2, 5) if not dtype.is_floating_point else (-1.5, 2.5)
    t = trandom.random_tensor(low, high, (4000,), dtype=dtype,
                              key=torch.Generator().manual_seed(1))
    assert t.dtype == dtype and t.shape == (4000,)
    assert float(t.min()) >= low and float(t.max()) <= high
    if not dtype.is_floating_point:
        assert set(t.tolist()) == set(range(low, high + 1))
    same = trandom.random_tensor(low, high, (4000,), dtype=dtype,
                                 key=torch.Generator().manual_seed(1))
    assert torch.equal(t, same)
    random.seed(9)
    a = trandom.random_tensor(low, high, (8,), dtype=dtype, device="cpu")
    random.seed(9)
    assert torch.equal(a, trandom.random_tensor(low, high, (8,), dtype=dtype,
                                                device="cpu"))


def test_sample_spherical_coords_contract():
    """Azimuth in its range, elevation in its range with its sine uniform
    (area-preserving): the sine's mean and quartiles within 0.02 of the
    uniform's."""
    az, el = trandom.sample_spherical_coords(
        (20000,), azimuth_low=0.5, azimuth_high=2.0, elevation_low=-0.3,
        elevation_high=1.2, key=torch.Generator().manual_seed(2))
    assert az.shape == el.shape == (20000,) and az.dtype == torch.float32
    assert 0.5 <= float(az.min()) and float(az.max()) <= 2.0
    assert -0.3 - 1e-6 <= float(el.min()) and float(el.max()) <= 1.2 + 1e-6
    lo, hi = math.sin(-0.3), math.sin(1.2)
    s = torch.sin(el.double())
    for q in (0.25, 0.5, 0.75):
        assert abs(float(torch.quantile(s, q)) - (lo + q * (hi - lo))) < 0.02
    again = trandom.sample_spherical_coords(
        (20000,), 0.5, 2.0, -0.3, 1.2, key=torch.Generator().manual_seed(2))
    assert torch.equal(again[0], az) and torch.equal(again[1], el)


def test_random_spc_octrees_f31():
    """F31: JAX's ``random_spc_octrees`` imports a name its points module
    lacks and raises ImportError. The port's: valid octrees
    (``check_spc_octrees``), each equal to JAX's
    ``unbatched_points_to_octree`` of the same quantized draws."""
    from kaolin_tpu.ops.spc.points import unbatched_points_to_octree
    with pytest.raises(ImportError):
        jrandom.random_spc_octrees(2, 3, key=jax.random.PRNGKey(0))
    random.seed(5)
    octrees, lengths = trandom.random_spc_octrees(
        3, 4, key=torch.Generator().manual_seed(8))
    assert ttesting.check_spc_octrees(octrees, lengths, batch_size=3)
    assert lengths.dtype == torch.int32
    random.seed(5)
    gen = torch.Generator().manual_seed(8)
    start = 0
    for length in lengths.tolist():
        n = random.randint(8, 64)
        pts = torch.rand((n, 3), generator=gen) * 2.0 - 1.0
        q = np.floor(np.clip(16 * (pts.numpy() + 1.0) / 2.0, 0, 15)).astype(
            np.int16)
        want = np.asarray(unbatched_points_to_octree(jnp.asarray(q), 4))
        np.testing.assert_array_equal(
            octrees[start:start + length].numpy(), want)
        start += length
    assert trandom.uint8_to_bits is not None


# -- coords, reduction -----------------------------------------------------
def test_coords_match_jax():
    rng = np.random.RandomState(0)
    az, el, d = (rng.uniform(-3, 3, 50).astype(np.float32),
                 rng.uniform(-1.5, 1.5, 50).astype(np.float32),
                 rng.uniform(0.1, 4, 50).astype(np.float32))
    t = [torch.from_numpy(x) for x in (az, el, d)]
    for dist in (True, False):
        got = tcoords.spherical2cartesian(t[0], t[1], t[2] if dist else None)
        want = jcoords.spherical2cartesian(jnp.asarray(az), jnp.asarray(el),
                                           jnp.asarray(d) if dist else None)
        for g, w in zip(got, want):
            assert_close(g, w, 1e-6)
    xyz = rng.randn(3, 50).astype(np.float32)
    got = tcoords.cartesian2spherical(*[torch.from_numpy(x) for x in xyz])
    want = jcoords.cartesian2spherical(*[jnp.asarray(x) for x in xyz])
    for g, w in zip(got, want):
        assert_close(g, w, 1e-6)


def test_packed_simple_sum_matches_jax():
    x = np.random.RandomState(1).randn(10, 3).astype(np.float32)
    numel = [3, 0, 7]
    assert_close(treduction.packed_simple_sum(torch.from_numpy(x), numel),
                 jbatch.packed_simple_sum(jnp.asarray(x), numel), 1e-6)


# -- utils.testing and env_vars --------------------------------------------
def test_check_tensor_family():
    t = torch.zeros(2, 3, 4)
    assert ttesting.check_tensor(t, (2, None, 4), torch.float32)
    assert not ttesting.check_tensor(t, (2, 3), throw=False)
    assert not ttesting.check_tensor(t, (2, 5, 4), throw=False)
    assert not ttesting.check_tensor(t, dtype=torch.int64, throw=False)
    with pytest.raises(ValueError):
        ttesting.check_tensor(t, (2, 3))
    with pytest.raises(TypeError):
        ttesting.check_tensor(t, dtype=torch.int64)
    assert ttesting.check_packed_tensor(torch.zeros(5, 3), 5, 3)
    with pytest.raises(ValueError):
        ttesting.check_packed_tensor(t)
    padded = torch.full((2, 4, 3), -1.0)
    padded[0, :2] = 1.0
    padded[1, :3] = 2.0
    assert ttesting.check_padded_tensor(padded, -1.0, [[2], [3]], 2, [4], 3,
                                        torch.float32)
    padded[1, 3] = 5.0
    assert not ttesting.check_padded_tensor(padded, -1.0, [[2], [3]],
                                            throw=False)
    with pytest.raises(TypeError):
        ttesting.check_spc_octrees(torch.zeros(3), torch.tensor([3]))
    with pytest.raises(ValueError):
        ttesting.check_spc_octrees(torch.zeros(3, dtype=torch.uint8),
                                   torch.tensor([2]))
    mesh = {"vertices": torch.zeros(5, 3), "faces": torch.zeros(4, 3)}
    assert ttesting.check_tensor_attribute_shapes(mesh, vertices=(5, 3),
                                                  faces=(None, 3))
    with pytest.raises(ValueError):
        ttesting.check_tensor_attribute_shapes(mesh, vertices=(4, 3))


def test_seeding():
    """``seed_everything`` seeds the three generators and returns a seeded
    ``torch.Generator``; ``with_seed`` passes one as ``key`` where the
    function takes it, and seeds before every call."""
    g = ttesting.seed_everything(4, device="cpu")
    draws = (random.random(), np.random.rand(), float(torch.rand(1)),
             float(torch.rand(1, generator=g)))

    @ttesting.with_seed(4, device="cpu")
    def with_key(key):
        return (random.random(), np.random.rand(), float(torch.rand(1)),
                float(torch.rand(1, generator=key)))

    @ttesting.with_seed(4)
    def without_key():
        return np.random.rand()

    assert with_key() == with_key() == draws
    assert without_key() == draws[1]
    other = torch.Generator().manual_seed(0)
    assert with_key(key=other)[3] == float(
        torch.rand(1, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("make", ["GraphConv", "manual_seed",
                                  "seed_everything", "with_seed"])
def test_generators_default_to_the_card(make):
    """Without a key or a device, ``GraphConv``'s parameters and the
    generators of ``manual_seed``, ``seed_everything`` and ``with_seed``
    are made on the CUDA device; on a machine without one they raise and
    name ``device='cpu'``, and with it they land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    calls = {
        "GraphConv": lambda **kw: tgcn.GraphConv(3, 4, **kw).w,
        "manual_seed": lambda **kw: trandom.manual_seed(0, **kw),
        "seed_everything": lambda **kw: ttesting.seed_everything(0, **kw),
        "with_seed": lambda **kw: ttesting.with_seed(1, **kw)(
            lambda key: key)(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()
    assert calls[make](device="cpu").device.type == "cpu"


def test_comparisons_match_jax(tmp_path, capsys):
    """``contained_torch_equal``, ``contained_allclose``, ``tensor_info``,
    ``check_allclose``, ``assert_images_close`` and ``file_contents_equal``
    on tensors as JAX's on the same arrays; the print helpers print."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"x": [a, "s", 3], "y": (a * 2, {"z": 1.5})}
    other = {"x": [a, "s", 3], "y": (a * np.float32(2.000002), {"z": 1.5})}

    def torchify(tree):
        if isinstance(tree, dict):
            return {k: torchify(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(torchify(v) for v in tree)
        return torch.from_numpy(tree) if isinstance(tree, np.ndarray) \
            else tree

    for approx in (False, True):
        assert ttesting.contained_torch_equal(
            torchify(tree), torchify(other), approximate=approx) == \
            jtesting.contained_torch_equal(tree, other, approximate=approx)
    assert ttesting.contained_allclose(torchify(tree), torchify(other)) == \
        jtesting.contained_allclose(tree, other) is True
    assert not ttesting.contained_torch_equal(torchify(tree), {"x": 1},
                                              print_error_context="t")
    assert "Mismatch at t" in capsys.readouterr().out
    assert ttesting.tensor_info(torch.from_numpy(a), "a") == \
        jtesting.tensor_info(a, "a")
    with pytest.raises(ValueError, match="not close"):
        ttesting.check_allclose(torch.from_numpy(a), torch.from_numpy(a + 1))
    img = np.random.RandomState(0).rand(10, 10, 3).astype(np.float32)
    noisy = img.copy()
    noisy[0, 0] += 0.5
    ttesting.assert_images_close(torch.from_numpy(img),
                                 torch.from_numpy(noisy))
    with pytest.raises(AssertionError):
        ttesting.assert_images_close(torch.from_numpy(img),
                                     torch.from_numpy(noisy),
                                     max_percent_disagreeing_pixels=0.5)
    (tmp_path / "a").write_text("x\n\n y\n# t 1\n")
    (tmp_path / "b").write_text("x\ny\n# t 2\n")
    for pkg in (ttesting, jtesting):
        assert not pkg.file_contents_equal(tmp_path / "a", tmp_path / "b")
        assert pkg.file_contents_equal(tmp_path / "a", tmp_path / "b",
                                       exclude_pattern="# t")
    ttesting.print_dict_attributes({"v": torch.zeros(2), "n": 3}, name="d")
    from collections import namedtuple
    ttesting.print_namedtuple_attributes(namedtuple("P", "v")(torch.ones(1)))
    out = capsys.readouterr().out
    assert "Attributes of d" in out and "v: (2,)" in out and "n: (int) 3" \
        in out


def test_env_vars_match_jax(monkeypatch):
    for name in ("KaolinTestEnvVars", "KaolinEnvVars"):
        t, j = getattr(tenv, name), getattr(jenv, name)
        assert issubclass(t, enum.Enum)
        assert {m.name: m.value for m in t} == {m.name: m.value for m in j}
    monkeypatch.setenv("KAOLIN_TEST_SHREC16_PATH", "/data/shrec")
    assert tenv.get_env(tenv.KaolinTestEnvVars.TEST_SHREC16_PATH) == \
        jenv.get_env(jenv.KaolinTestEnvVars.TEST_SHREC16_PATH) == \
        "/data/shrec"
    assert tenv.get_env("KAOLIN_UNSET_FOR_TEST", "d") == "d"
