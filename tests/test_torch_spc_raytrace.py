"""kaolin_tpu_torch SPC raytracing and packed ray ops against kaolin_tpu's,
on the CPU.

Both packages build the scene from the same numpy mesh or points, and the
same numpy rays go to both. Tolerances:
- nugget streams (``ridx``, ``pidx``, their order, valid masks, level
  counts and overflow flags) exactly equal, and t_in/t_out bit for bit: the
  slab test is JAX's subtract-then-multiply with min/max from integer cell
  coords, which has nothing to contract or reorder;
- packed ops within 1e-6 relative (the Hillis–Steele scan and the segment
  sums add in another order than XLA), their gradients within 1e-5 of the
  largest entry;
- the ``spc_depth`` golden at the thresholds of
  ``tests/render/test_golden_corpus.py``.

Two faults of the JAX package are held here as reference-side, not copied:
F19, its ``prod_reduce`` has no gradient (``scatter_mul`` with repeated
indices), so the port's gradient is held against each pack's ``jnp.prod``;
F20, its per-ray traversal above level 10 carries Morton codes in int32,
which wrap, so the port is held against JAX where the wrap does no harm and
against a brute-force oracle where it does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops import spc as spc_jax
from kaolin_tpu.ops.conversions import unbatched_mesh_to_spc as m2s_jax
from kaolin_tpu.render.camera import Camera as CameraJax
from kaolin_tpu.render.camera import generate_rays as generate_rays_jax
from kaolin_tpu.render.spc import raytrace as rt_jax
from kaolin_tpu.utils.testing import assert_images_close
from kaolin_tpu_torch.ops import spc
from kaolin_tpu_torch.render.camera import Camera, generate_rays
from kaolin_tpu_torch.render.spc import raytrace as rt
from tests.render.golden_corpus import GOLDEN_DIR
from tests.render.test_raytrace import _brute_force_hits
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

EX = load_example("torch_spc_raytrace")
REL, GRAD_TOL = 1e-6, 1e-5
RES = 48


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def eq(port, jax_value):
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(jax_value))


def jax_scene(octree_np):
    """JAX's (octree, exsum, point hierarchy, pyramid) of an octree."""
    oj = jnp.asarray(octree_np)
    _, pyr, ex = spc_jax.scan_octrees(oj, np.array([len(oj)], np.int32))
    return oj, ex, spc_jax.generate_points(oj, pyr, ex), np.asarray(pyr)[0]


@pytest.fixture(scope="module")
def mesh_scene():
    """The example's scene at level 6, both packages, and view 3's rays at
    48² (numpy; the example makes the rays JAX's camera makes)."""
    level = 6
    port = EX.spc_scene(level, "cpu")
    oj, ex, ph, pyr = jax_scene(port["octree"].numpy())
    o, d = (x.numpy() for x in EX.view_rays(3, RES, "cpu"))
    return {"level": level, "port": port, "jax": (oj, ex, ph, pyr),
            "rays": (o, d)}


def streams(port_out, jax_out, names):
    for p, j, name in zip(port_out, jax_out, names):
        assert p.dtype == torch.from_numpy(np.asarray(j)).dtype, name
        eq(p, j)


@pytest.mark.parametrize("capacity", [4 * RES * RES, 3000])
def test_frontier_matches_jax(mesh_scene, capacity):
    """The whole state, the level counts and the overflow flag equal JAX's,
    with room and with a capacity that overflows."""
    s, (oj, ex, _, _), (o, d) = (mesh_scene["port"], mesh_scene["jax"],
                                 mesh_scene["rays"])
    level = mesh_scene["level"]
    port = rt._raytrace_frontier(s["octree"], s["exsum"], t(o), t(d), level,
                                 capacity)
    want = rt_jax._raytrace_frontier(oj, ex, jnp.asarray(o), jnp.asarray(d),
                                     level, capacity)
    streams(port, want, "ridx nidx t_in t_out valid counts overflowed".split())
    assert bool(port[-1]) == (capacity == 3000)


@pytest.mark.parametrize("capacity", [20_000, 3000])
def test_fixed_matches_jax(mesh_scene, capacity):
    s, (oj, ex, _, _), (o, d) = (mesh_scene["port"], mesh_scene["jax"],
                                 mesh_scene["rays"])
    level = mesh_scene["level"]
    port = rt._raytrace_fixed(s["octree"], s["exsum"], t(o), t(d), level,
                              capacity)
    want = rt_jax._raytrace_fixed(oj, ex, jnp.asarray(o), jnp.asarray(d),
                                  level, capacity)
    streams(port, want, "ridx nidx t_in t_out valid counts overflowed".split())


@pytest.mark.parametrize("compaction", ["sort", "rank"])
def test_perray_matches_jax(mesh_scene, compaction):
    """Valid slots, their nuggets and the overflow flag equal JAX's (8
    slots a ray overflow at level 6, 16 do not; the rank compaction at 8)."""
    s, (oj, ex, _, _), (o, d) = (mesh_scene["port"], mesh_scene["jax"],
                                 mesh_scene["rays"])
    level = mesh_scene["level"]
    for k in (8, 16) if compaction == "sort" else (8,):
        port = rt._raytrace_perray(s["octree"], s["exsum"], t(o), t(d),
                                   level, k, compaction)
        want = rt_jax._raytrace_perray(oj, ex, jnp.asarray(o), jnp.asarray(d),
                                       level, k, compaction)
        valid = np.asarray(want[4])
        eq(port[4], valid)
        for p, j in zip(port[:4], want[:4]):
            eq(p[torch.from_numpy(valid)], np.asarray(j)[valid])
        assert bool(port[5]) == bool(want[5])


CORNERS = {"x-y-high": (1500, 1300, 700), "x-y-low": (500, 300, 1700),
           "x-high-y-low": (1500, 300, 700)}


@pytest.fixture(scope="module")
def level11():
    """Three level-11 cubes of 6 voxels a side, every third voxel left out,
    one at each of ``CORNERS``, in one octree, and 6 x 6 rays along +z
    through each; the port's and JAX's per-ray traversals of all the
    rays."""
    level, side, n = 11, 6, 6
    a = np.arange(side)
    cube = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3)
    cube = cube[cube.sum(1) % 3 != 0]
    q = np.concatenate([cube + c for c in CORNERS.values()]).astype(np.int16)
    rays = []
    for c in CORNERS.values():
        lo = (np.asarray(c) + 0.3) / 2 ** level * 2 - 1
        hi = (np.asarray(c) + side - 0.3) / 2 ** level * 2 - 1
        ys, xs = np.meshgrid(np.linspace(lo[1], hi[1], n),
                             np.linspace(lo[0], hi[0], n), indexing="ij")
        rays.append(np.stack([xs.ravel(), ys.ravel(),
                              np.full(n * n, -2.0)], -1))
    o = np.concatenate(rays).astype(np.float32)
    d = np.tile(np.array([1e-4, 2e-4, 1.0], np.float32), (len(o), 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    octree = spc.unbatched_points_to_octree(q, level, device="cpu")
    _, pyr, ex = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    oj, exj, _, _ = jax_scene(octree.numpy())
    return {"q": q, "o": o, "d": d, "n": n * n,
            "ph": spc.generate_points(octree, pyr, ex).numpy(),
            "port": rt._raytrace_perray(octree, ex, t(o), t(d), level, 16),
            "jax": rt_jax._raytrace_perray(oj, exj, jnp.asarray(o),
                                           jnp.asarray(d), level, 16,
                                           "sort")}


@pytest.mark.parametrize("cube", list(CORNERS))
def test_perray_level11(level11, cube):
    """Above level 10 the port carries int64 Morton codes. Every ray's
    nuggets equal a brute-force slab test of every voxel; where the x and y
    top bits agree, JAX's int32 codes decode right and the streams equal
    its own, Morton codes modulo 2^32 (F20); where they differ JAX loses
    the hits."""
    s = level11
    port, want = s["port"], s["jax"]
    assert port[1].dtype == torch.int64 and not bool(port[5])
    i = list(CORNERS).index(cube)
    rows = range(i * s["n"], (i + 1) * s["n"])
    assert int(port[4][i * s["n"]:(i + 1) * s["n"]].sum()) > 2 * s["n"]
    for r in rows:
        hits = _brute_force_hits(s["o"][r], s["d"][r],
                                 s["q"].astype(np.int64), 11)
        v = port[4][r]
        assert [w for _, w in hits] == [tuple(s["ph"][p])
                                        for p in port[0][r][v]]
        np.testing.assert_allclose(port[2][r][v].numpy(),
                                   [w for w, _ in hits], atol=1e-6)
    rows = slice(rows.start, rows.stop)
    valid = np.asarray(want[4])[rows]
    if cube == "x-high-y-low":
        assert valid.sum() < int(port[4][rows].sum())
        return
    eq(port[4][rows], valid)
    v = torch.from_numpy(valid)
    for p, j in zip((port[0], port[2], port[3]),
                    (want[0], want[2], want[3])):
        eq(p[rows][v], np.asarray(j)[rows][valid])
    eq(port[1][rows][v].to(torch.int32), np.asarray(want[1])[rows][valid])


def test_unbatched_raytrace_dispatch_matches_jax():
    """Each dispatch of ``unbatched_raytrace`` gives JAX's nuggets: the
    frontier growing its capacity (64 rays through a dense level-4 SPC
    make more than 1,024 nuggets a level), the per-ray path on an octree
    too large for packed records (2^20 empty bytes appended), equal to
    the frontier's, an
    explicit ``max_nuggets`` with and without overflow (the warning), and
    ``return_depth``/``with_exit``."""
    level = 4
    octree, _ = spc.create_dense_spc(level)
    _, pyr, ex = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    ph = spc.generate_points(octree, pyr, ex)
    oj, exj, phj, pyrj = jax_scene(octree.numpy())
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[-2.0, -1.7, -2.3]], np.float32), (64, 1))
    d = (rng.uniform(0.3, 0.7, (64, 3)) * [1, 0.9, 1.1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = (octree, ph, pyr[0], ex, t(o), t(d), level)
    jargs = (oj, phj, pyrj, exj, jnp.asarray(o), jnp.asarray(d), level)
    counts = rt.raytrace_overflow_report(*args, 10 ** 6)["level_counts"]
    assert counts.max() > 1024                       # the capacity grows
    for kw in (dict(), dict(with_exit=True), dict(return_depth=False)):
        streams(rt.unbatched_raytrace(*args, **kw),
                rt_jax.unbatched_raytrace(*jargs, **kw), "ridx pidx t".split())
    with pytest.warns(UserWarning, match="overflowed"):
        port = rt.unbatched_raytrace(*args, max_nuggets=700)
    with pytest.warns(UserWarning, match="overflowed"):
        want = rt_jax.unbatched_raytrace(*jargs, max_nuggets=700)
    streams(port, want, "ridx pidx t".split())
    frontier = rt.unbatched_raytrace(*args, with_exit=True)
    import unittest.mock as mock
    with mock.patch.object(rt, "_raytrace_frontier",
                           side_effect=AssertionError("frontier")):
        octree_big = torch.cat([octree, torch.zeros(1 << 20, dtype=torch.uint8)])
        perray = rt.unbatched_raytrace(octree_big, ph, pyr[0],
                                       torch.cat([ex, ex.new_full(
                                           (1 << 20,), int(ex[-1]))]),
                                       t(o), t(d), level, with_exit=True)
    for a, b in zip(perray, frontier):
        eq(a, b.numpy())


def test_overflow_report_matches_jax(mesh_scene):
    s, (oj, ex, phj, pyrj), (o, d) = (mesh_scene["port"], mesh_scene["jax"],
                                      mesh_scene["rays"])
    level = mesh_scene["level"]
    for cap in (3000, 20_000):       # test_fixed_matches_jax's compiles
        port = rt.raytrace_overflow_report(
            s["octree"], s["point_hierarchy"], s["pyramid"], s["exsum"],
            t(o), t(d), level, cap)
        want = rt_jax.raytrace_overflow_report(
            oj, phj, pyrj, ex, jnp.asarray(o), jnp.asarray(d), level, cap)
        assert port.keys() == want.keys()
        np.testing.assert_array_equal(port["level_counts"],
                                      want["level_counts"])
        for k in ("max_level_count", "capacity", "overflowed"):
            assert port[k] == want[k], k
        assert port["overflowed"] == (cap == 3000)


# -- packed ray ops ------------------------------------------------------
def packs(seed, n=300, d=3, zeros=False):
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, n // 5, n))
    feats = rng.uniform(0.2, 1.5, (n, d)).astype(np.float32)
    if zeros:
        feats[rng.rand(n, d) < 0.05] = 0.0
        feats[ids == ids[10]] = 0.0            # a pack of zeros only
    return ids.astype(np.int32), feats


def close(port, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(port.detach().numpy(), want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()))


def grad_close(port_grad, want_grad):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(port_grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


@pytest.mark.parametrize("op", ["cumsum", "cumprod"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_scans_match_jax(op, exclusive, reverse):
    """Values within 1e-6 relative and gradients within 1e-5 of max|g|,
    with zeros for the product."""
    ids, feats = packs(1, n=64, zeros=(op == "cumprod"))
    b = rt.mark_pack_boundaries(t(ids))
    eq(b, rt_jax.mark_pack_boundaries(jnp.asarray(ids)))
    w = np.random.RandomState(2).randn(*feats.shape).astype(np.float32)
    x = t(feats).requires_grad_(True)
    out = getattr(rt, op)(x, b, exclusive=exclusive, reverse=reverse)
    (out * t(w)).sum().backward()

    def f(x):
        y = getattr(rt_jax, op)(x, jnp.asarray(b.numpy()),
                                exclusive=exclusive, reverse=reverse)
        return jnp.sum(y * w), y
    (_, want), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(feats))
    close(out, want)
    grad_close(x.grad, g)


def test_scan_restarts_at_each_pack():
    """A pack's scan does not carry what came before it: a large first pack
    leaves a small later pack exact (a global cumsum minus each pack's
    offset would cancel there)."""
    feats = np.array([[1e8], [1e8], [1e-3], [2e-3]], np.float32)
    b = torch.tensor([True, False, True, False])
    out = rt.cumsum(t(feats), b)
    assert out[2, 0] == np.float32(1e-3)
    assert out[3, 0] == np.float32(1e-3) + np.float32(2e-3)


def test_reductions_and_diff_match_jax():
    ids, feats = packs(3)
    b = rt.mark_pack_boundaries(t(ids))
    bj = jnp.asarray(b.numpy())
    w = np.random.RandomState(4).randn(int(b.sum()), 3).astype(np.float32)
    for name in ("sum_reduce", "diff"):
        x = t(feats).requires_grad_(True)
        out = getattr(rt, name)(x, b)
        ww = w if name == "sum_reduce" else np.ones_like(feats)
        (out * t(ww)).sum().backward()
        fj = getattr(rt_jax, name)
        close(out, fj(jnp.asarray(feats), bj))
        grad_close(x.grad, jax.grad(lambda x: jnp.sum(fj(x, bj) * ww))(
            jnp.asarray(feats)))
    with pytest.warns(DeprecationWarning):
        eq(rt.mark_first_hit(t(ids)), rt_jax.mark_pack_boundaries(
            jnp.asarray(ids)))


@pytest.mark.parametrize("zeros", [False, True])
def test_prod_reduce_matches_jax(zeros):
    """Values equal JAX's ``segment_prod`` within 1e-6 relative. JAX's
    ``prod_reduce`` raises on a gradient (F19), so the port's gradient is
    held against each pack's ``jnp.prod`` gradient, zeros included."""
    ids, feats = packs(5, zeros=zeros)
    b = rt.mark_pack_boundaries(t(ids))
    x = t(feats).requires_grad_(True)
    out = rt.prod_reduce(x, b)
    close(out, rt_jax.prod_reduce(jnp.asarray(feats), jnp.asarray(b.numpy())))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: rt_jax.prod_reduce(
            x, jnp.asarray(b.numpy())).sum())(jnp.asarray(feats))
    w = np.random.RandomState(6).randn(*out.shape).astype(np.float32)
    (out * t(w)).sum().backward()
    # each pack's entries in a row of a (packs, longest pack) table, the
    # rest of the row 1
    seg = np.cumsum(b.numpy()) - 1
    pos = np.arange(len(ids)) - np.flatnonzero(b.numpy())[seg]
    rows = np.full((seg[-1] + 1, pos.max() + 1), len(ids))
    rows[seg, pos] = np.arange(len(ids))

    def per_pack(x):
        padded = jnp.concatenate([x, jnp.ones_like(x[:1])])[rows]
        return jnp.prod(padded, axis=1)
    close(out, per_pack(jnp.asarray(feats)))
    grad_close(x.grad, jax.jit(jax.grad(lambda x: jnp.sum(per_pack(x) * w)))(
        jnp.asarray(feats)))


def test_exponential_integration_matches_jax():
    ids, feats = packs(7)
    tau = np.random.RandomState(8).uniform(0, 2, (len(ids), 1)).astype(
        np.float32)
    b = rt.mark_pack_boundaries(t(ids))
    bj = jnp.asarray(b.numpy())
    for exclusive in (True, False):
        x, tt = t(feats).requires_grad_(True), t(tau).requires_grad_(True)
        out, trans = rt.exponential_integration(x, tt, b, exclusive)
        (out.sum() + trans.sum()).backward()

        n_packs = int(b.sum())

        def f(x, tt, b):
            # with traced boundaries JAX's sum_reduce gives a row a nugget,
            # the packs' first
            o, tr = rt_jax.exponential_integration(x, tt, b, exclusive)
            return o[:n_packs], tr

        def loss(x, tt, b):
            o, tr = f(x, tt, b)
            return o.sum() + tr.sum()
        (want, want_t), (gx, gt) = jax.jit(
            lambda x, tt, b: (f(x, tt, b), jax.grad(loss, argnums=(0, 1))(
                x, tt, b)))(jnp.asarray(feats), jnp.asarray(tau), bj)
        close(out, want)
        close(trans, want_t)
        grad_close(x.grad, gx)
        grad_close(tt.grad, gt)


# -- the golden and the JAX example --------------------------------------
def test_golden_spc_depth():
    """``golden_corpus.render_spc_depth`` (level 7, 128², the fixed
    traversal) rendered by the port reproduces ``spc_depth.png``."""
    from PIL import Image

    res, level = 128, 7
    rng = np.random.RandomState(0)
    grid = 2 ** level
    d = rng.randn(60_000, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.concatenate([d * 0.62, d * 0.615])
    q = np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                          grid - 1), axis=0)
    octree = spc.unbatched_points_to_octree(q.astype(np.int16), level,
                                            device="cpu")
    _, _, exsum = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    cam = Camera.from_args(eye=torch.tensor([1.6, 1.2, 1.8]),
                           at=torch.zeros(3),
                           up=torch.tensor([0.0, 1.0, 0.0]), fov=0.8,
                           width=res, height=res)
    o, v = generate_rays(cam)
    ridx, _, t_in, _, valid, _, _ = rt._raytrace_fixed(
        octree, exsum, o, v, level, 8 * res * res)
    tt = torch.where(valid, t_in, torch.inf)
    img = torch.full((res * res,), torch.inf).scatter_reduce(
        0, ridx.long(), tt, "amin").reshape(res, res).numpy()
    hit = np.isfinite(img)
    lo, hi = img[hit].min(), img[hit].max()
    img = np.where(hit, 1.0 - (img - lo) / max(hi - lo, 1e-6), 0.0)
    gold = np.asarray(Image.open(f"{GOLDEN_DIR}/spc_depth.png"),
                      dtype=np.float32) / 255.0
    assert_images_close(gold, np.clip(img, 0.0, 1.0),
                        pixel_disagreement_threshold=0.1,
                        max_percent_disagreeing_pixels=1.0)


def test_spc_raytrace_example_scene_matches_jax():
    """``examples/spc_raytrace.py``'s scene (the icosphere at level 6) and
    its 64² depth map, from JAX's rays, equal JAX's."""
    level, res = 6, 64
    v, f = EX.icosphere()
    port = EX.spc_scene(level, "cpu", face_vertices=v[f])
    octree_j, _ = m2s_jax(jnp.asarray(v)[jnp.asarray(f)], level)
    eq(port["octree"], octree_j)
    oj, exj, phj, pyrj = jax_scene(np.asarray(octree_j))
    cam = CameraJax.from_args(eye=jnp.asarray([1.8, 1.2, 1.8]),
                              at=jnp.zeros(3), up=jnp.asarray([0., 1., 0.]),
                              fov=0.7, width=res, height=res)
    o, d = (np.asarray(x) for x in generate_rays_jax(cam))
    frame = EX.depth_render(port, (t(o), t(d)))
    ridx, _, depth = rt_jax.unbatched_raytrace(oj, phj, pyrj, exj,
                                               jnp.asarray(o),
                                               jnp.asarray(d), level)
    first = np.asarray(rt_jax.mark_pack_boundaries(ridx))
    want = np.full((res * res,), np.inf, np.float32)
    want[np.asarray(ridx)[first]] = np.asarray(depth)[first, 0]
    eq(frame["depth"], want)
    assert 0.2 < np.isfinite(want).mean() < 0.6
