"""kaolin_tpu_torch's Bayesian-fusion reconstruction against kaolin_tpu's,
on the CPU.

The fixture is ``tests/ops/test_bf_recon.py``'s: a sphere shell at level 6
seen from six views at 128², sigma 0.05. Both packages carve the same
frames: the port's ``RayTracedSPCDataset`` (held against JAX's in
``tests/test_torch_spc_more.py``), handed to the JAX package as numpy.
The JAX references run without XLA's contraction into fused multiply-adds
and with ``rsqrt`` as ``1 / sqrt`` (``tests/torch_parity.py::
jax_without_contraction``); then the octree and empty bytes, exsums,
pyramids and colors are equal and the probabilities within 1e-5 (they
are equal). ``test_compiled_jax_parts_by_rounding_alone`` holds what the
JAX package's compiled arithmetic changes (ROADMAP Queue C, F24).
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.ops.spc as jspc
import kaolin_tpu_torch.ops.spc as tspc
from kaolin_tpu_torch.utils.interop import bf_spc_from_jax
from tests.torch_parity import (  # noqa: F401
    frame_tuple,
    jax_without_contraction,
    torch_threads_per_worker,
    warm_torch_exp,
)

importlib.import_module("kaolin_tpu.ops.spc.bf_recon")
importlib.import_module("kaolin_tpu_torch.ops.spc.bf_recon")
JB = sys.modules["kaolin_tpu.ops.spc.bf_recon"]
TB = sys.modules["kaolin_tpu_torch.ops.spc.bf_recon"]

LEVEL = 6
SIGMA = 0.05
PROB_TOL = 1e-5
VIEWS = np.array([
    [6.0, 0.0, 0.9], [-6.0, 0.0, 0.9], [0.0, 6.0, 0.9],
    [0.0, -6.0, 0.9], [0.9, 0.9, 6.0], [0.9, 0.9, -6.0],
], dtype=np.float32)


@pytest.fixture(scope="module")
def shell_octree():
    """``tests/ops/test_bf_recon.py``'s solid-shell sphere octree, built by
    both packages (equal bytes)."""
    res = 2 ** LEVEL
    g = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    pts = np.stack(np.nonzero(np.abs(r - 0.6) < (2.5 / res)),
                   axis=-1).astype(np.int16)
    port = tspc.unbatched_points_to_octree(torch.from_numpy(pts), LEVEL)
    want = jspc.unbatched_points_to_octree(jnp.asarray(pts), LEVEL)
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))
    return port


@pytest.fixture(scope="module")
def frames(shell_octree):
    """The six views at 128² → (tensor frames, numpy frames)."""
    ds = tspc.RayTracedSPCDataset(VIEWS, shell_octree, res=7)
    tf = [ds[i] for i in range(len(ds))]
    return tf, [frame_tuple(f, True) for f in tf]


@pytest.fixture(scope="module")
def chain(frames):
    """Both packages' per-frame SPCs, the running fusions and the extracted
    surface, from the same numpy frames (JAX without contraction)."""
    _, np_frames = frames
    with jax_without_contraction():
        jf = [JB.process_frame(f, LEVEL, SIGMA) for f in np_frames]
        jfuse = [jf[0]]
        for f in jf[1:]:
            jfuse.append(JB.fuse_bf(jfuse[-1], f))
        jext = JB.extract_bq(jfuse[-1])
        jrec = JB.bf_recon(np_frames, LEVEL, SIGMA)
    tf = [TB.process_frame(f, LEVEL, SIGMA) for f in np_frames]
    tfuse = [tf[0]]
    for f in tf[1:]:
        tfuse.append(TB.fuse_bf(tfuse[-1], f))
    return {"jax": (jf, jfuse, jext, jrec),
            "port": (tf, tfuse, TB.extract_bq(tfuse[-1]),
                     TB.bf_recon(np_frames, LEVEL, SIGMA))}


def assert_normals(got, want, tol=PROB_TOL):
    """Normals within ``tol`` where finite; NaN where JAX's are NaN (a
    depth step from a missed ray, inf − inf)."""
    got, want = got.numpy(), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], atol=tol, rtol=0)


def assert_spc_equal(got, want):
    assert got["level"] == want["level"] == LEVEL
    for k in ("octree", "empty", "exsum", "pyramid", "colors"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["probabilities"].numpy(),
                               np.asarray(want["probabilities"]),
                               atol=PROB_TOL, rtol=0)
    assert_normals(got["normals"], want["normals"])


# -- per-voxel pieces ------------------------------------------------------
def test_profile_curves_match_jax():
    """The profile and its derivative on [-4, 7], with the segment ends and
    the clamps at -3 and 6, bit for bit against JAX's eager ops; the JAX
    test's limits."""
    xs = np.concatenate([np.linspace(-4.0, 7.0, 4401),
                         np.arange(-3.0, 7.0), [5.99, 5.999999]]) \
        .astype(np.float32)
    for name in ("bq_profile", "dbq_profile"):
        want = np.asarray(getattr(JB, name)(jnp.asarray(xs)))
        got = getattr(TB, name)(torch.from_numpy(xs)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    p = TB.bq_profile(torch.tensor([-5.0, -3.0, 7.0, 100.0])).numpy()
    np.testing.assert_allclose(p, [0.0, 0.0, 0.5, 0.5], atol=1e-7)
    ps = TB.bq_profile(torch.from_numpy(xs[:4401])).numpy()
    assert 0.85 < ps.max() < 0.95


def test_build_mip2d_matches_jax(frames):
    _, np_frames = frames
    f = np_frames[0]
    for true_depth in (True, False):
        with jax_without_contraction():
            want_d, want_m = JB.build_mip2d(f[1], f[3], 6, f[4], true_depth)
        got_d, got_m = TB.build_mip2d(torch.from_numpy(f[1]), f[3], 6, f[4],
                                      true_depth)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        assert len(got_m) == len(want_m) == 6
        for g, w in zip(got_m, want_m):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_identify_empty_three_classes(chain):
    """The walk on the fused SPC at every level-6 cell and at coords
    outside the grid: occupied leaves (>= 0), observed-empty space (-1)
    and unseen space (-2 - depth), equal to JAX's."""
    _, jfuse, _, _ = chain["jax"]
    _, tfuse, _, _ = chain["port"]
    grid = np.stack(np.meshgrid(*[np.arange(64)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    outside = np.array([[-1, 0, 0], [64, 3, 3], [5, -7, 70], [0, 0, 64]])
    coords = np.concatenate([grid, outside]).astype(np.int32)
    s = tfuse[-1]
    got = TB.identify_empty(s["octree"], s["empty"], s["exsum"],
                            torch.from_numpy(coords), LEVEL).numpy()
    js = jfuse[-1]
    want = np.asarray(jax.jit(JB.identify_empty, static_argnums=4)(
        js["octree"], js["empty"], js["exsum"], jnp.asarray(coords), LEVEL))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any() and (got <= -2).any()
    assert set(np.unique(got[got < -1])) <= {-2 - d for d in range(LEVEL)}
    np.testing.assert_array_equal(got[-4:], -1)
    # the float query (the densifier's) floors [-1, 1] onto the grid
    fq = (coords[:-4] + 0.5) / 32.0 - 1.0
    np.testing.assert_array_equal(
        TB.unbatched_query(s["octree"], s["empty"], s["exsum"],
                           torch.from_numpy(fq.astype(np.float32)),
                           LEVEL).numpy(), got[:-4])


# -- frames, fusion, extraction ---------------------------------------------
@pytest.mark.parametrize("i", range(len(VIEWS)))
def test_process_frame_matches_jax(chain, i):
    assert_spc_equal(chain["port"][0][i], chain["jax"][0][i])


@pytest.mark.parametrize("k", range(1, len(VIEWS)))
def test_fuse_bf_matches_jax(chain, k):
    assert_spc_equal(chain["port"][1][k], chain["jax"][1][k])


def test_extract_bq_matches_jax(chain):
    got, want = chain["port"][2], chain["jax"][2]
    for g, w, name in zip(got[:3], want[:3], ("octree", "empty", "colors")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert_normals(got[3], want[3])
    level, pyr, _ = tspc.scan_octrees(got[0], torch.tensor([len(got[0])]))
    assert level == LEVEL and got[2].shape[0] == int(pyr[0, 0, LEVEL]) > 0


def test_bf_recon_matches_jax(chain):
    got, want = chain["port"][3], chain["jax"][3]
    for g, w, name in zip(got[:3], want[:3], ("octree", "empty", "colors")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert_normals(got[3], want[3])


def test_bf_recon_from_the_dataset(frames, shell_octree):
    """``bf_recon`` over the dataset itself (tensor frames) equals the
    numpy frames' result, and carves as ``tests/ops/test_bf_recon.py``
    asks: outside observed empty, inside unseen, the surface occupied."""
    ds = tspc.RayTracedSPCDataset(VIEWS, shell_octree, res=7)
    octree, empty, colors, normals = tspc.bf_recon(ds, LEVEL, SIGMA)
    ref = TB.bf_recon(frames[1], LEVEL, SIGMA)
    assert torch.equal(octree, ref[0]) and torch.equal(empty, ref[1])
    assert torch.equal(colors, ref[2])
    assert bool(torch.all((octree & empty) == octree))
    _, _, exsum = tspc.scan_octrees(octree, torch.tensor([len(octree)]))
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.95, 0.95, (4096, 3)).astype(np.float32)
    r = np.linalg.norm(pts, axis=-1)
    pidx = TB.unbatched_query(octree, empty, exsum, torch.from_numpy(pts),
                              LEVEL).numpy()
    assert (pidx[r > 0.75] == -1).mean() > 0.95
    assert (pidx[r < 0.45] < -1).mean() > 0.95
    assert (pidx[np.abs(r - 0.6) < 0.02] >= 0).mean() > 0.5


def test_bf_spc_from_jax_fuses_like_the_port(chain):
    """JAX's frame SPCs carried into the port fuse as the port's own."""
    jf = chain["jax"][0]
    fused = TB.fuse_bf(bf_spc_from_jax(jf[0]), bf_spc_from_jax(jf[1]))
    assert_spc_equal(fused, chain["jax"][1][1])


def test_degenerate_inputs_give_none(frames):
    """No frame with a hit, or a frame that carves everything away: the
    four Nones of a degenerate fusion."""
    f = frames[1][0]
    assert TB.bf_recon([f[:9] + (False,)], LEVEL, SIGMA) == (None,) * 4
    missed = (f[0], np.full_like(f[1], f[4]), *f[2:])
    assert TB.bf_recon([missed], LEVEL, SIGMA) == (None,) * 4
    assert JB.bf_recon([missed], LEVEL, SIGMA) == (None,) * 4


def test_module_names():
    """bf_recon's ``unbatched_query`` is reached through its module; the
    package's is ``ops/spc/spc.py``'s, as in the JAX package."""
    assert tspc.unbatched_query.__module__ == "kaolin_tpu_torch.ops.spc.spc"
    assert TB.unbatched_query is not tspc.unbatched_query
    assert TB.processFrame is TB.process_frame
    assert TB.fuseBF is TB.fuse_bf and TB.extractBQ is TB.extract_bq
    from kaolin_tpu_torch.ops.spc.exsum_compat import ensure_current_exsum
    assert TB.ensure_current_exsum is ensure_current_exsum
    for name in ("bf_recon", "build_mip2d", "extract_bq", "fuse_bf",
                 "process_frame"):
        assert getattr(tspc, name) is getattr(TB, name)


def test_compiled_jax_parts_by_rounding_alone(frames):
    """F24: the JAX package's compiled arithmetic rounds where the port's
    does not. XLA's CPU ``rsqrt``, like the port's ``1 / sqrt``, is within
    an ulp of the correctly rounded value (so within two of each other), and
    jitted, the profile's Bezier is contracted into fused multiply-adds: it
    moves by a few ulps, and whether a value is exactly 0.5 (an unseen
    corner) then differs only within 0.02 of the clamp at 6, where the
    segment's value is within an ulp of 0.5. Nothing else parts the two:
    without both (``jax_without_contraction``) every state is equal."""
    u = np.linspace(0.0, 2.0, 20001, dtype=np.float32) + 1.0
    rounded = (1.0 / np.sqrt(u.astype(np.float64))).astype(np.float32)

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()

    fast = np.asarray(jax.lax.rsqrt(jnp.asarray(u)))
    port = (1.0 / torch.sqrt(torch.from_numpy(u))).numpy()
    assert ulps(fast, rounded) == ulps(port, rounded) == 1

    xs = np.linspace(-4.0, 7.0, 200001, dtype=np.float32)
    compiled = np.asarray(jax.jit(JB.bq_profile)(jnp.asarray(xs)))
    port = TB.bq_profile(torch.from_numpy(xs)).numpy()
    assert np.abs(compiled - port).max() <= 4 * np.spacing(np.float32(1.0))
    parted = (compiled == 0.5) != (port == 0.5)
    assert np.all(np.abs(xs[parted] - 6.0) < 0.02)


def test_perray_exsum_path_reads_no_dead_slot(shell_octree, monkeypatch):
    """F27: the per-ray traversal of an octree too large for the packed
    node table (8 x its bytes at 2^23 or more: the densifier's level-8
    shells) read the exsum at its dead slots' stale indices, past the
    array's end: an IndexError here, a device assert on the card. Forced
    onto that path, the fixture's views give the frontier's nuggets."""
    from kaolin_tpu_torch.render.camera import Camera, generate_rays
    from kaolin_tpu_torch.render.spc import raytrace

    _, pyr, exsum = tspc.scan_octrees(shell_octree,
                                      torch.tensor([len(shell_octree)]))
    ph = tspc.generate_points(shell_octree, pyr, exsum)
    cam = Camera.from_args(eye=torch.tensor([2.3, 2.3, 2.3]),
                           at=torch.zeros(3), up=torch.tensor([0., 0., 1.]),
                           fov=0.644, width=48, height=48)
    origin, direction = generate_rays(cam)
    want = raytrace.unbatched_raytrace(shell_octree, ph, pyr[0], exsum,
                                       origin, direction, LEVEL)
    monkeypatch.setattr(raytrace, "_NODE_TABLE_LIMIT", 0)
    got = raytrace.unbatched_raytrace(shell_octree, ph, pyr[0], exsum,
                                      origin, direction, LEVEL)
    assert want[0].shape[0] > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
