"""kaolin_tpu_torch SPC first-hit raster against kaolin_tpu's, on the CPU.

The scenes of ``tests/render/test_spc_raster.py`` are built by both
packages from the same numpy points; the JAX payload and camera parameters
are carried into the port with ``from_numpy_tree``. The JAX raster runs its
Pallas kernels in interpret mode, the port its kernels' plain versions.

Tolerances:
- payload, binning tables, counts and overflow counts: exactly equal, and
  the depth quantum ``dz`` bit for bit (the binning is the same plain
  arithmetic);
- depths: within rtol 2e-6 / atol 1e-6, valid pixels equal. Both ray builds
  are op for op, but XLA's CPU backend contracts some products and sums
  into fused multiply-adds;
- ids: equal wherever the depths are bitwise equal, which must hold for at
  least 75% of the valid pixels (the policy of the JAX suite).
"""

import importlib.util
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops.spc import scan_octrees as scan_octrees_jax
from kaolin_tpu.ops.spc import (
    unbatched_points_to_octree as points_to_octree_jax,
)
from kaolin_tpu.ops.spc.spc import generate_points as generate_points_jax
from kaolin_tpu.render.camera import Camera as CameraJax
from kaolin_tpu.render.camera import CameraExtrinsics as CameraExtrinsicsJax
from kaolin_tpu.render.camera import PinholeIntrinsics as PinholeIntrinsicsJax
from kaolin_tpu.render.camera.raygen import generate_rays as generate_rays_jax
from kaolin_tpu.render.spc import raster as raster_jax
from kaolin_tpu.render.spc.raytrace import unbatched_raytrace
from kaolin_tpu_torch.ops import spc
from kaolin_tpu_torch.render.camera import (
    Camera,
    CameraExtrinsics,
    PinholeIntrinsics,
)
from kaolin_tpu_torch.render.spc import (
    RasterSPC,
    build_raster_spc,
    cuda_raster,
    raster,
    raster_first_hit,
    raster_first_hit_sequence,
)
from kaolin_tpu_torch.utils.interop import from_numpy_tree
from tests.torch_parity import ROOT

EYES = ([1.4, 1.0, 1.3], [0.1, 2.0, 0.1], [-1.8, -0.4, 0.6])


def shell_points(level, radii, n=20000, seed=0):
    """``_sphere_spc``'s points: random directions on shells, quantized."""
    rng = np.random.RandomState(seed)
    grid = 2 ** level
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.concatenate([d * r for r in radii])
    return np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                             grid - 1), axis=0).astype(np.int16)


def blob_points(seed, level=5):
    """The clustered random octree: 4 blobs and uniform dust."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.6, 0.6, (4, 3)).astype(np.float32)
    pts = np.concatenate(
        [c + 0.12 * rng.randn(300, 3).astype(np.float32) for c in centers]
        + [rng.uniform(-1, 1, (100, 3)).astype(np.float32)])
    grid = 2 ** level
    return np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                             grid - 1), axis=0).astype(np.int16)


# name → (points, level, eye, resolution, c_cap); tile_px 8, s_max 16
SCENES = {
    **{f"L{lv}-eye{i}": (lambda lv=lv: shell_points(lv, (0.6, 0.25)), lv,
                         eye, 32, 64)
       for lv in (3, 5) for i, eye in enumerate(EYES)},
    **{f"blobs{s}": (lambda s=s: blob_points(s), 5, [1.5, 0.9, -1.2], 32,
                     128) for s in (1, 2)},
    "inside": (lambda: shell_points(4, (0.8,)), 4, [0.05, 0.02, 0.04], 16,
               128),
}


class Scene(NamedTuple):
    level: int
    res: int
    c_cap: int
    points: np.ndarray
    ph_jax: object
    pyramid_jax: np.ndarray
    octree_jax: object
    exsum_jax: object
    rspc_jax: object
    cam_jax: object
    rspc: RasterSPC
    cam: Camera


def camera_pair(eye, res, fov=0.9):
    """A JAX camera and the port's camera with the same parameters."""
    jcam = CameraJax.from_args(eye=jnp.asarray(eye, jnp.float32),
                               at=jnp.zeros(3, jnp.float32),
                               up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                               fov=fov, width=res, height=res)
    params = from_numpy_tree((jcam.extrinsics.params, jcam.intrinsics.params),
                             "cpu")
    return jcam, Camera(CameraExtrinsics(params[0]),
                        PinholeIntrinsics(res, res, params[1]))


def make_scene(points, level, eye, res, c_cap):
    octree = points_to_octree_jax(jnp.asarray(points), level)
    _, pyramids, exsum = scan_octrees_jax(octree,
                                          np.array([len(octree)], np.int32))
    ph = generate_points_jax(octree, pyramids, exsum)
    pyramid = np.asarray(pyramids)[0]
    rspc_jax = raster_jax.build_raster_spc(ph, pyramid, level)
    jcam, cam = camera_pair(eye, res)
    return Scene(level, res, c_cap, points, ph, pyramid, octree, exsum,
                 rspc_jax, jcam, RasterSPC(*from_numpy_tree(rspc_jax, "cpu")),
                 cam)


@pytest.fixture(scope="module")
def scenes():
    return {name: make_scene(points(), level, eye, res, c_cap)
            for name, (points, level, eye, res, c_cap) in SCENES.items()}


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """JAX ``raster_first_hit`` of every scene, once per module."""
    return {name: [np.asarray(x) for x in raster_jax.raster_first_hit(
        s.rspc_jax, s.cam_jax, tile_px=8, s_max=16, c_cap=s.c_cap)[:3]]
        for name, s in scenes.items()}


def assert_depths_match(t, nidx, valid, t_ref, nidx_ref, valid_ref):
    """The module's tolerance policy; ``t_ref`` may be inf on a miss."""
    np.testing.assert_array_equal(valid, valid_ref)
    assert valid.any()
    np.testing.assert_allclose(t[valid], t_ref[valid], rtol=2e-6, atol=1e-6)
    exact = t[valid] == t_ref[valid]
    assert exact.mean() >= 0.75, exact.mean()
    np.testing.assert_array_equal(nidx[valid][exact],
                                  nidx_ref[valid][exact])
    assert (nidx[~valid] == -1).all() and np.isinf(t[~valid]).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_raster_spc_matches_jax(scenes, name):
    s = scenes[name]
    octree = spc.unbatched_points_to_octree(s.points, s.level)
    _, pyramids, exsum = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    ph = spc.generate_points(octree, pyramids, exsum)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(s.ph_jax))
    rspc = build_raster_spc(ph, pyramids[0], s.level)
    assert rspc.level == s.rspc_jax.level
    for got, want in zip(rspc[:4], s.rspc_jax[:4]):
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bin_units_matches_jax(scenes, name):
    s = scenes[name]
    kw = dict(width=s.res, height=s.res, tile_h=8, tile_w=8, s_max=16,
              c_cap=s.c_cap)
    params_jax = raster_jax._prep_camera(s.cam_jax)
    params = raster._prep_camera(s.cam)
    for got, want in zip(params, params_jax):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tab, counts, dz, ov = raster._bin_units(s.rspc.uaabb, *params, **kw)
    tab_j, counts_j, dz_j, ov_j = raster_jax._bin_units(s.rspc_jax.uaabb,
                                                        *params_jax, **kw)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(tab_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert dz.numpy().view(np.int32) == np.asarray(dz_j).view(np.int32)
    assert {k: int(v) for k, v in ov.items()} == \
        {k: int(v) for k, v in ov_j.items()}
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_raster_first_hit_matches_jax(scenes, jax_frames, name):
    s = scenes[name]
    t, nidx, valid, ov = raster_first_hit(s.rspc, s.cam, tile_px=8, s_max=16,
                                          c_cap=s.c_cap)
    assert t.shape == nidx.shape == valid.shape == (s.res * s.res,)
    assert (t.dtype, nidx.dtype, valid.dtype) == \
        (torch.float32, torch.int32, torch.bool)
    assert int(ov["slot_overflow"]) == 0 and int(ov["cap_overflow"]) == 0
    assert_depths_match(t.numpy(), nidx.numpy(), valid.numpy(),
                        *jax_frames[name])


def test_untile_plain_matches_jax():
    rng = np.random.RandomState(0)
    h, w, tp = 24, 40, 8
    depth_t = rng.rand(h * w // tp ** 2, tp * tp).astype(np.float32)
    ids_t = rng.randint(-1, 1000, depth_t.shape).astype(np.int32)
    d, i = raster.untile_plain(torch.from_numpy(depth_t),
                               torch.from_numpy(ids_t), height=h, width=w,
                               tile_px=tp)
    dj, ij = raster_jax._untile(jnp.asarray(depth_t)[..., None],
                                jnp.asarray(ids_t)[..., None], height=h,
                                width=w, tile_px=tp, interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


def test_sequence_matches_per_frame():
    points = shell_points(4, (0.6,))
    rspc = raster_scene(points, 4)
    cams = [camera_pair(eye, 16)[1] for eye in ([1.4, 1.0, 1.3],
                                                [0.0, 1.9, 0.3],
                                                [-1.2, -0.8, 1.0])]
    ts, ids, vs, ov = raster_first_hit_sequence(rspc, cams, tile_px=8,
                                                s_max=16, c_cap=64)
    assert ts.shape == (3, 256)
    assert int(ov["slot_overflow"]) == 0 and int(ov["cap_overflow"]) == 0
    for k, cam in enumerate(cams):
        t1, id1, v1, _ = raster_first_hit(rspc, cam, tile_px=8, s_max=16,
                                          c_cap=64)
        assert torch.equal(ts[k], t1) and torch.equal(ids[k], id1)
        assert torch.equal(vs[k], v1)


def raster_scene(points, level):
    octree = spc.unbatched_points_to_octree(points, level)
    _, pyramids, exsum = spc.scan_octrees(octree, torch.tensor([len(octree)]))
    return build_raster_spc(spc.generate_points(octree, pyramids, exsum),
                            pyramids[0], level)


def test_capacity_overflow_surfaced(scenes):
    """A tiny c_cap trips the diagnostic, with JAX's count."""
    points = shell_points(4, (0.6, 0.25))
    jcam, cam = camera_pair([1.4, 1.0, 1.3], 16)
    rspc = raster_scene(points, 4)
    _, _, _, ov = raster_first_hit(rspc, cam, tile_px=16, s_max=4, c_cap=1)
    assert int(ov["cap_overflow"]) > 0
    _, _, _, ov_j = raster_jax._bin_units(
        jnp.asarray(rspc.uaabb.numpy()), *raster_jax._prep_camera(jcam),
        width=16, height=16, tile_h=16, tile_w=16, s_max=4, c_cap=1)
    assert int(ov["cap_overflow"]) == int(ov_j["cap_overflow"])


def test_side_x_keeps_jax_split_and_fits_the_screen():
    for tx_n in range(1, 65):
        jax_side = min(4, tx_n)
        while 16 % jax_side:
            jax_side -= 1
        assert raster._side_x(16, tx_n) == jax_side
    assert raster._side_x(4, 1) == 1
    for tx_n in (1, 2, 4, 8, 16, 32, 64):
        for ty_n in (tx_n, 2 * tx_n):
            side = raster._side_x(tx_n * ty_n, tx_n)
            assert side == tx_n and tx_n * ty_n // side >= ty_n


def traversal_first_hit(s, cam_jax):
    """The JAX traversal's first hit per ray: min t_in, ties to the lowest
    point-hierarchy id."""
    origin, direction = generate_rays_jax(cam_jax)
    ridx, pidx, depth = unbatched_raytrace(
        s.octree_jax, s.ph_jax, s.pyramid_jax, s.exsum_jax,
        jnp.asarray(origin, jnp.float32), jnp.asarray(direction, jnp.float32),
        s.level)
    ridx, pidx = np.asarray(ridx), np.asarray(pidx)
    t = np.asarray(depth)[:, 0]
    best = np.full((origin.shape[0],), np.inf, np.float32)
    best_id = np.full((origin.shape[0],), -1, np.int32)
    for i in np.lexsort((pidx, t, ridx))[::-1]:
        best[ridx[i]] = t[i]
        best_id[ridx[i]] = pidx[i]
    return best, best_id


def test_camera_inside_clears_slot_overflow(scenes):
    """F2: a unit straddling the eye plane spans every tile. JAX's split
    caps it at 4 tile columns, so its slot overflow never clears; the
    port's grows with s_max, and then matches the traversal."""
    s = scenes["inside"]
    res = 64
    jcam, cam = camera_pair([0.05, 0.02, 0.04], res)
    params_jax = raster_jax._prep_camera(jcam)
    for s_max in (16, 64, 256, 1024):
        ov_j = raster_jax._bin_units(
            s.rspc_jax.uaabb, *params_jax, width=res, height=res, tile_h=8,
            tile_w=8, s_max=s_max, c_cap=128)[3]
        assert int(ov_j["slot_overflow"]) == 6

    caps, (t, nidx, valid, ov) = load_example().grow_caps(
        s.rspc, cam, caps=(8, 16, 64))
    assert caps[1] > 16
    assert int(ov["slot_overflow"]) == 0 and int(ov["cap_overflow"]) == 0
    best, _ = traversal_first_hit(s, jcam)
    valid = valid.numpy()
    np.testing.assert_array_equal(valid, np.isfinite(best))
    np.testing.assert_allclose(t.numpy()[valid], best[valid], rtol=2e-6,
                               atol=1e-6)


def test_too_many_units_or_tiles_raise():
    """F8: unit and tile ids must fit 15 bits of the packed int32 keys."""
    _, cam = camera_pair([1.4, 1.0, 1.3], 16)
    units = torch.zeros(1, 8, 128).expand(32769, 8, 128)
    big = RasterSPC(units, torch.zeros(1, 128, dtype=torch.int32).expand(
        32769, 128), torch.zeros(32769, 8), torch.zeros(8, 8), 9)
    with pytest.raises(ValueError, match="32769 units"):
        raster_first_hit(big, cam)
    params = raster._prep_camera(cam)
    with pytest.raises(ValueError, match="33024 tiles"):
        raster._bin_units(torch.zeros(4, 8), *params, width=2048,
                          height=1032, tile_h=8, tile_w=8, s_max=16, c_cap=4)


def test_namedtuple_round_trip(scenes):
    """F9: a namedtuple comes back as its own type; non-array fields stay
    Python values."""
    s = scenes["L3-eye0"]
    carried = from_numpy_tree(s.rspc_jax, "cpu")
    assert type(carried) is type(s.rspc_jax)
    assert carried.level == 3 and isinstance(carried.level, int)
    for got, want in zip(carried[:4], s.rspc_jax[:4]):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nested = from_numpy_tree({"s": s.rspc_jax, "l": [np.ones(2)]}, "cpu")
    assert isinstance(nested["s"], type(s.rspc_jax))
    assert isinstance(nested["l"][0], torch.Tensor)


def load_example():
    path = os.path.join(ROOT, "examples", "torch_spc_raster.py")
    spec = importlib.util.spec_from_file_location("torch_spc_raster", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_matches_jax():
    """``examples/torch_spc_raster.py`` at level 5 and 64², its own camera
    and payload, against JAX's raster of the same scene."""
    ex = load_example()
    inputs = ex.config3_inputs(level=5, n=20000)
    rspc, cam, sp = ex.build_scene(inputs, "cpu", 64)
    caps, (t, nidx, valid, ov) = ex.grow_caps(rspc, cam)
    assert caps == ex.START_CAPS
    assert t.shape == (64 * 64,) and bool(torch.isfinite(t[valid]).all())
    s = make_scene(inputs["points"], 5, inputs["eye"].tolist(), 64, caps[2])
    np.testing.assert_array_equal(sp["point_hierarchy"].numpy(),
                                  np.asarray(s.ph_jax))
    # the example's camera is within 1e-6 of JAX's; JAX renders with the
    # very parameters of the example's camera, so both see one scene
    jcam = CameraJax.from_args(eye=jnp.asarray(inputs["eye"]),
                               at=jnp.zeros(3), up=jnp.asarray(inputs["up"]),
                               fov=inputs["fov"], width=64, height=64)
    np.testing.assert_allclose(cam.extrinsics.params.numpy(),
                               np.asarray(jcam.extrinsics.params), atol=1e-6)
    jcam = CameraJax(
        CameraExtrinsicsJax(jnp.asarray(cam.extrinsics.params.numpy())),
        PinholeIntrinsicsJax(64, 64,
                             jnp.asarray(cam.intrinsics.params.numpy())))
    t_j, nidx_j, valid_j, _ = raster_jax.raster_first_hit(
        s.rspc_jax, jcam, tile_px=caps[0], s_max=caps[1], c_cap=caps[2])
    assert_depths_match(t.numpy(), nidx.numpy(), valid.numpy(),
                        np.asarray(t_j), np.asarray(nidx_j),
                        np.asarray(valid_j))


def test_cuda_wrappers_refuse_cpu_tensors(scenes):
    s = scenes["L3-eye0"]
    params = raster._prep_camera(s.cam)
    tab, counts, dz, _ = raster._bin_units(
        s.rspc.uaabb, *params, width=32, height=32, tile_h=8, tile_w=8,
        s_max=16, c_cap=64)
    cam = raster._camera_vector(*params)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles_cuda(tab, counts, dz, cam, s.rspc.l3boxes,
                                      s.rspc.units, s.rspc.uaabb, width=32,
                                      height=32, tile_px=8)
    depth_t, ids_t = raster.raster_tiles_plain(
        tab, counts, dz, cam, s.rspc.l3boxes, s.rspc.units, s.rspc.uaabb,
        width=32, height=32, tile_px=8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.untile_cuda(depth_t, ids_t, height=32, width=32,
                                tile_px=8)
    assert cuda_raster.raster_tiles_cuda.launches == 0
    assert cuda_raster.untile_cuda.launches == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_raster_tiles_plain_counts_its_slab_tests(scenes, name):
    """``work`` leaves the result as it is and counts whole units of 128
    leaves for every pixel of a tile: at least the first unit of each tile
    with units, at most every unit binned; one unit-box test per pixel and
    unit walked, and at most that many units' leaves needed."""
    s = scenes[name]
    params = raster._prep_camera(s.cam)
    tab, counts, dz, _ = raster._bin_units(
        s.rspc.uaabb, *params, width=s.res, height=s.res, tile_h=8, tile_w=8,
        s_max=16, c_cap=s.c_cap)
    args = (tab, counts, dz, raster._camera_vector(*params), s.rspc.l3boxes,
            s.rspc.units, s.rspc.uaabb)
    size = dict(width=s.res, height=s.res, tile_px=8)
    work = {}
    got = raster.raster_tiles_plain(*args, **size, work=work)
    want = raster.raster_tiles_plain(*args, **size)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    per_unit = 64 * 128
    n = work["slab_tests"]
    assert n % per_unit == 0
    assert int((counts > 0).sum()) <= n // per_unit <= int(counts.sum())
    assert work["unit_tests"] * 128 == n
    assert work["needed_leaf_tests"] % 128 == 0
    assert 0 < work["needed_leaf_tests"] <= n


def walk_each_tile(tab, counts, dz, cam, l3boxes, units, uaabb, *, width,
                   height, tile_px):
    """The tile walk recounted by brute force, one tile at a time, slot by
    slot, with the port's ``_rays``, ``_slab`` and ``uaabb`` → (counts as
    ``raster_tiles_plain(work=...)`` gives them, best depths (T, P), and
    the (pixel, unit) pairs where a leaf hits nearer than the pixel's best
    although its ray does not enter the unit's box nearer than that)."""
    c_cap, t_n = tab.shape
    batch = next(b for b in (4, 2, 1) if c_cap % b == 0)
    tx_n, p = width // tile_px, tile_px * tile_px
    si = torch.arange(p)
    work = {"slab_tests": 0, "unit_tests": 0, "needed_leaf_tests": 0}
    misses = 0
    depth = torch.full((t_n, p), 3.0e38)
    for t in range(t_n):
        origin, inv = raster._rays(cam, (t // tx_n) * tile_px + si // tile_px,
                                   (t % tx_n) * tile_px + si % tile_px,
                                   width, height)
        bound = raster._exit_bound(l3boxes, origin, [i[None] for i in inv])[0]
        best = torch.full((p,), 3.0e38)
        n = int(counts[t])
        for s in range(n):
            uid = int(tab[s, t]) >> 16
            box = uaabb[uid]
            t_box, _, hit_box = raster._slab([box[k] for k in range(3)],
                                             [box[3 + k] for k in range(3)],
                                             origin, inv)
            enters = hit_box & (t_box < best)
            u = units[uid]
            t_in, _, hit = raster._slab([u[k] for k in range(3)],
                                        [u[3 + k] for k in range(3)], origin,
                                        [i[:, None] for i in inv])
            nearer = (hit & (t_in < best[:, None])).any(dim=1)
            misses += int((nearer & ~enters).sum())
            work["slab_tests"] += p * 128
            work["unit_tests"] += p
            work["needed_leaf_tests"] += 128 * int(enters.sum())
            m = torch.where(hit, t_in, 3.0e38).amin(dim=1)
            best = torch.where(m < best, m, best)
            nxt = s + 1
            if nxt % batch == 0 and nxt < n:
                z_lb = (tab[min(nxt, c_cap - 1), t] & 0xFFFF).float() * dz
                if bool(torch.minimum(best, bound).amax() < z_lb):
                    break
        depth[t] = best
    return work, depth, misses


def cull_scene(name):
    """(rspc, camera, caps) of the scenes the unit cull is checked on."""
    ex = load_example()
    if name == "blobs L5 64²":
        inputs = {"points": blob_points(1), "level": 5,
                  "eye": np.float32([1.5, 0.9, -1.2]), "res": 64}
    elif name == "shell L7 128²":
        inputs = {"points": shell_points(7, (0.6, 0.25)), "level": 7,
                  "eye": np.float32([1.4, 1.0, 1.3]), "res": 128}
    else:   # the camera inside a level-4 shell
        inputs = {"points": shell_points(4, (0.8,)), "level": 4,
                  "eye": np.float32([0.05, 0.02, 0.04]), "res": 64}
    inputs.update(at=np.zeros(3, np.float32), up=np.float32([0, 1, 0]),
                  fov=0.9)
    rspc, cam, _ = ex.build_scene(inputs, "cpu", inputs["res"])
    caps, _ = ex.grow_caps(rspc, cam, caps=(8, 16, 64))
    return rspc, cam, caps


@pytest.mark.parametrize("name", ["blobs L5 64²", "shell L7 128²",
                                  "inside L4 64²"])
def test_unit_cull_loses_no_hit(name):
    """The tile kernel skips a unit's leaves for a warp when no ray of the
    warp enters the unit's box nearer than its best. On these scenes no
    leaf hits nearer than a pixel's best unless the pixel's ray enters the
    unit's box nearer than that, so the cull changes no result; and the
    counts of ``raster_tiles_plain(work=...)`` equal a tile-by-tile
    recount."""
    rspc, cam, (tile_px, s_max, c_cap) = cull_scene(name)
    params = raster._prep_camera(cam)
    tab, counts, dz, ov = raster._bin_units(
        rspc.uaabb, *params, width=cam.width, height=cam.height,
        tile_h=tile_px, tile_w=tile_px, s_max=s_max, c_cap=c_cap)
    assert all(int(v) == 0 for v in ov.values())
    args = (tab, counts, dz, raster._camera_vector(*params), rspc.l3boxes,
            rspc.units, rspc.uaabb)
    size = dict(width=cam.width, height=cam.height, tile_px=tile_px)
    work = {}
    depth, _ = raster.raster_tiles_plain(*args, **size, work=work)
    recount, depth_r, misses = walk_each_tile(*args, **size)
    assert misses == 0
    assert work == recount
    assert torch.equal(depth.view(torch.int32), depth_r.view(torch.int32))
    assert bool((depth < 1.0e38).any())
    # the cull has work to save
    assert work["needed_leaf_tests"] < work["slab_tests"]


def test_tile_kernel_takes_tiles_of_at_most_16_pixels():
    """Four threads a pixel: a 16-px tile is a block of 1024 threads."""
    assert cuda_raster._tiles(64, 64, 16) == (4, 4)
    with pytest.raises(ValueError, match="tile_px"):
        cuda_raster._tiles(64, 64, 32)
