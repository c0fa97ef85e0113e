"""kaolin_tpu_torch.parallel against kaolin_tpu.parallel, on the CPU.

The port runs on 2 gloo ranks, spawned once for the module
(``tests/torch_parallel_workers.py``, which imports neither jax nor
kaolin_tpu; the ranks report what they loaded). JAX runs the same calls on
a mesh of ``jax.devices()[:2]`` (the conftest's virtual CPU devices).
Tolerances: chamfer within 1e-5 relative; DIB-R's face ids equal, image
and soft mask within 1e-5; the MLP step's params within 1e-5 of max|p| and
its loss within 1e-5 relative, the draw made equal by patching, in the
ranks only, the port's draw to return JAX's from the same key; the demo
batch's displacements B z within 2e-5 of max|B z| of JAX's sharded batch
(the port's QR may pick other pivots than JAX's, so z is compared through
B z). The scene-batch tests mirror
``tests/parallel/test_heterogeneous_batch.py`` and
``tests/parallel/test_sharded_ops.py`` on the port with their asserts.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_workers as workers
from kaolin_tpu.parallel import (
    sharded_chamfer_distance as chamfer_jax,
    sharded_dibr_rasterization as dibr_jax,
    sharded_mlp_train_step as mlp_step_jax,
)
from kaolin_tpu.parallel.simplicits import (
    bucket_pad_targets as bucket_jax,
    make_demo_scene as demo_scene_jax,
    pad_skinned_physics_points as pad_jax,
    stack_scenes as stack_scenes_jax,
)
from kaolin_tpu.physics.simplicits import SkinnedPhysicsPoints as PointsJax
from kaolin_tpu.physics.simplicits.network import (
    mlp_apply as mlp_apply_jax,
    mlp_init as mlp_init_jax,
)
from kaolin_tpu_torch.parallel import simplicits as ps
from kaolin_tpu_torch.physics.simplicits import (
    SkinnedPhysicsPoints,
    mlp_apply,
    mlp_init,
)
from kaolin_tpu_torch.render.mesh.dibr import dibr_rasterization
from torch_parity import (  # noqa: F401
    jax_unoptimized,
    torch_threads_per_worker,
    warm_torch_exp,
)

WORLD = 2
SIZES = [(40, 3), (24, 4), (40, 3), (24, 4)]

pytestmark = pytest.mark.usefixtures("jax_unoptimized")


def baked_arrays(seed, num_qp, num_handles):
    """``test_heterogeneous_batch.py``'s ``_baked`` as keyword arrays."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (num_qp, 3)).astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs),
                        np.ones((num_qp, 1), np.float32)], axis=1)
    dwdx = np.zeros((num_qp, num_handles, 3), np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    return dict(pts=pts, yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
                skinning_weights=w, dwdx=dwdx)


def dibr_inputs():
    rng = np.random.RandomState(0)
    tri = rng.randn(4, 24, 3, 3).astype(np.float32) * 0.2
    return dict(height=16, width=16, fvz=tri[..., 2] - 2.0,
                fvi=np.ascontiguousarray(tri[..., :2]),
                feats=rng.rand(4, 24, 3, 3).astype(np.float32),
                nz=np.ones((4, 24), np.float32))


def mlp_inputs():
    """``test_sharded_ops.py``'s MLP step at 2 ranks: 16 points, 5 handles,
    one hidden layer of 16; JAX's params, points and draw from key 0."""
    key = jax.random.PRNGKey(0)
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in mlp_init_jax(key, 3, 16, num_handles=5, num_layers=1)]
    n = 8 * WORLD
    return dict(params=params,
                pts=np.asarray(jax.random.uniform(key, (n, 3))),
                yms=np.full((n,), 1e4, np.float32),
                prs=np.full((n,), 0.45, np.float32),
                rhos=np.full((n,), 500.0, np.float32),
                tfms=np.asarray(0.1 * jax.random.normal(key, (4, 4, 3, 4))))


@pytest.fixture(scope="module", autouse=True)
def ranks_started(tmp_path_factory):
    """Every port call of the module, started at the module's start on 2
    gloo ranks: the JAX side of the first test runs while they work."""
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.RandomState(0)
    bucket = ps.bucket_pad_targets(SIZES)
    jobs = {
        "chamfer": ("chamfer", dict(
            p1=rng.rand(2 * WORLD, 64, 3).astype(np.float32),
            p2=rng.rand(2 * WORLD, 96, 3).astype(np.float32))),
        "dibr": ("dibr", dibr_inputs()),
        "mlp": ("mlp", mlp_inputs()),
        "draw": ("draw", dict(seed=3, batch_size=4, num_handles=4)),
        "demo": ("demo_batch", dict(seeds=[0, 1], steps=3)),
        "padded": ("padded_batch", dict(
            arrays=[baked_arrays(20 + i, nq, nh)
                    for i, (nq, nh) in enumerate(SIZES)],
            pad=bucket, steps=4)),
    }
    out = tmp / "results.pkl"
    threads = max(1, torch.get_num_threads() // WORLD)
    ctx = mp.start_processes(
        workers.run, args=(WORLD, str(tmp / "init"), jobs, str(out),
                           threads),
        nprocs=WORLD, join=False, start_method="spawn")
    yield ctx, out, jobs
    for proc in ctx.processes:
        if proc.is_alive():
            proc.terminate()
        proc.join()


@pytest.fixture(scope="module")
def ranks(ranks_started):
    """The ranks' results, once they have all ended."""
    ctx, out, jobs = ranks_started
    while not ctx.join():
        pass
    with open(out, "rb") as f:
        results = pickle.load(f)
    results["inputs"] = {k: kw for k, (_, kw) in jobs.items()}
    return results


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:WORLD]), axis_names=("dp",))


def _put(jmesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("dp")))


def test_demo_batch_matches_jax_sharded_batch(request, jmesh):
    """``test_sharded_ops.py``'s scene batch: a demo scene (contact, a
    kinematic plate, QR) a rank, 3 sharded steps against JAX's. JAX's
    ``sharded_scene_batch_step`` builds its program (``jax.jit`` of
    ``shard_map`` over the mesh's ``"dp"`` axis of ``jax.vmap`` of the
    scenes' step) and compiles it anew at every call, so the program is
    built here once, as that function builds it, and takes the three
    steps. It is the module's first test, and waits for the ranks after
    its JAX side."""
    scenes = [demo_scene_jax(s) for s in (0, 1)]
    step, consts, state = stack_scenes_jax(scenes)
    spec = P("dp")
    consts, state = jax.device_put((consts, state),
                                   NamedSharding(jmesh, spec))
    program = jax.jit(shard_map(
        lambda c, st: jax.vmap(step)(c, *st), mesh=jmesh,
        in_specs=(spec, (spec, spec, spec)), out_specs=(spec, spec, spec),
        check_vma=False))
    for _ in range(3):
        state = program(consts, state)
    got, z = request.getfixturevalue("ranks")["demo"]
    assert np.isfinite(z).all() and np.abs(z).max() > 1e-6
    for i, s in enumerate(scenes):
        s.sim_z = state[0][i]
        want = np.asarray(s.get_object_deformed_pts(0))
        rest = np.asarray(s.sim_pts)[:32]
        disp = want - rest
        np.testing.assert_allclose(got[i] - rest, disp, rtol=0,
                                   atol=2e-5 * np.abs(disp).max())


def test_ranks_load_neither_jax_nor_kaolin_tpu(ranks):
    assert ranks["loaded"] == [[]] * WORLD


def test_sharded_chamfer_matches_jax(ranks, jmesh):
    inp = ranks["inputs"]["chamfer"]
    want = chamfer_jax(jmesh, _put(jmesh, inp["p1"]), _put(jmesh, inp["p2"]))
    np.testing.assert_allclose(ranks["chamfer"], np.asarray(want), rtol=1e-5)


def test_sharded_dibr_matches_jax_and_the_unsharded_call(ranks, jmesh):
    inp = ranks["inputs"]["dibr"]
    img, soft, idx, grad = ranks["dibr"]
    want = dibr_jax(jmesh, inp["height"], inp["width"],
                    *(_put(jmesh, inp[k]) for k in ("fvz", "fvi", "feats",
                                                    "nz")))
    np.testing.assert_array_equal(idx, np.asarray(want[2]))
    np.testing.assert_allclose(img, np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(soft, np.asarray(want[1]), atol=1e-5)
    # the unsharded port call: the same values and gradient
    fvi = torch.from_numpy(inp["fvi"]).requires_grad_(True)
    outs = dibr_rasterization(inp["height"], inp["width"],
                              torch.from_numpy(inp["fvz"]), fvi,
                              torch.from_numpy(inp["feats"]),
                              torch.from_numpy(inp["nz"]))
    outs[1].sum().backward()
    for got, o in zip((img, soft, idx), outs):
        np.testing.assert_array_equal(got, o.detach().numpy())
    # the plain backward sums a vertex's terms in an order that depends on
    # the batch it is given: a few entries lie an ulp apart
    want_g = fvi.grad.numpy()
    np.testing.assert_allclose(grad, want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())


def test_sharded_mlp_train_step_matches_jax(ranks, jmesh):
    inp = ranks["inputs"]["mlp"]
    key = jax.random.PRNGKey(0)
    n = inp["pts"].shape[0]
    want_p, want_loss = mlp_step_jax(
        jmesh, [{k: jnp.asarray(v) for k, v in p.items()}
                for p in inp["params"]],
        jax.device_put(jnp.asarray(inp["pts"]),
                       NamedSharding(jmesh, P("dp", None))),
        jnp.full((n,), 1e4), jnp.full((n,), 0.45), jnp.full((n,), 500.0),
        appx_vol=1.0, key=key)
    got_p, got_loss = ranks["mlp"]
    assert np.isfinite(got_loss)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    for g, w, old in zip(got_p, want_p, inp["params"]):
        for k in ("w", "b"):
            w_k = np.asarray(w[k])
            np.testing.assert_allclose(g[k], w_k, rtol=0,
                                       atol=1e-5 * np.abs(w_k).max())
    # the params moved
    assert any(not np.allclose(g[k], o[k]) for g, o in
               zip(got_p, inp["params"]) for k in ("w", "b"))


def test_port_draw_is_seeded_normal(ranks):
    """The port's own draw: (B, H−1, 3, 4), 0.1·N(0, 1), the same twice
    from one seed."""
    a, b = ranks["draw"]
    assert a.shape == (4, 4, 3, 4) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert 0.05 < a.std() < 0.2


def test_mlp_init_and_apply_against_jax():
    key = jax.random.PRNGKey(1)
    params = mlp_init_jax(key, 3, 64, num_handles=33, num_layers=6)
    x = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    carried = [{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
               for p in params]
    np.testing.assert_allclose(
        mlp_apply(carried, torch.from_numpy(x)).numpy(),
        np.asarray(mlp_apply_jax(params, jnp.asarray(x))), rtol=0,
        atol=1e-6)
    gen = torch.Generator().manual_seed(5)
    mine = mlp_init(gen, 3, 64, 33, 6)
    again = mlp_init(torch.Generator().manual_seed(5), 3, 64, 33, 6)
    assert len(mine) == len(params) == 8
    for m, a, j in zip(mine, again, params):
        for k in ("w", "b"):
            assert m[k].shape == j[k].shape and m[k].dtype == torch.float32
            assert torch.equal(m[k], a[k])
            bound = m["w"].shape[0] ** -0.5
            assert float(m[k].abs().max()) <= bound


def test_demo_scene_has_full_product_features():
    scene = ps.make_demo_scene(0, device="cpu")
    assert "collision" in scene.force_dict
    objs = list(scene.sim_obj_dict.values())
    assert any(o.is_kinematic for o in objs)
    assert any(o.apply_qr for o in objs)
    assert len(scene.dyn_idx) < scene.total_dofs


@pytest.mark.parametrize("args", [
    ((0, 48, 3), 80, 5), ((1, 40, 4), 64, 6), ((2, 16, 1), 36, 1),
    ((3, 40, 3), 40, 3)])
def test_pad_skinned_physics_points_is_jax_bit_for_bit(args):
    (seed, nq, nh), qp, handles = args
    arrays = baked_arrays(seed, nq, nh)
    want = pad_jax(PointsJax(**arrays), qp, handles)
    got = ps.pad_skinned_physics_points(SkinnedPhysicsPoints(**arrays), qp,
                                        handles)
    for k in ("pts", "yms", "prs", "rhos", "skinning_weights", "dwdx"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.appx_vol == want.appx_vol
    assert got.num_real_qp == getattr(want, "num_real_qp", None)
    with pytest.raises(ValueError):
        ps.pad_skinned_physics_points(SkinnedPhysicsPoints(**arrays), nq - 1)


@pytest.mark.parametrize("sizes", [SIZES, [(40, 3), (56, 4), (24, 5)],
                                   [(10, 2)], [(100, 1), (8, 9)]])
def test_bucket_pad_targets_matches_jax(sizes):
    assert ps.bucket_pad_targets(sizes) == bucket_jax(sizes)


def _unpadded_run(arrays, steps, collisions=False):
    s = workers.scene_of(arrays, collisions=collisions)
    for _ in range(steps):
        s.run_sim_step()
    return s.get_object_deformed_pts(0).numpy()


@pytest.mark.parametrize("pad_handles,collisions", [
    (0, False), (2, False), (2, True)])
def test_padded_scene_matches_unpadded_trajectory(pad_handles, collisions):
    """Zero-mass phantom points and phantom handles leave the real
    dynamics as they are through 10 steps (8 with contact)."""
    seed, nq, nh, qp = (1, 48, 3, 80) if collisions else (0, 40, 4, 64)
    arrays = baked_arrays(seed, nq, nh)
    steps = 8 if collisions else 10
    ref = _unpadded_run(arrays, steps, collisions)
    pad = workers.scene_of(arrays, (qp, nh + pad_handles), collisions)
    for _ in range(steps):
        pad.run_sim_step()
    np.testing.assert_allclose(pad.get_object_deformed_pts(0)[:nq].numpy(),
                               ref, rtol=1e-4, atol=1e-5)


def test_three_different_sized_scenes_batch_together():
    """3 sizes padded to their bucket, stacked and stepped as one vmapped
    batch, against their sequential unpadded runs."""
    sizes = [(40, 3), (56, 4), (24, 5)]
    bucket = ps.bucket_pad_targets(sizes)
    arrays = [baked_arrays(10 + i, nq, nh) for i, (nq, nh) in
              enumerate(sizes)]
    scenes = [workers.scene_of(a, bucket) for a in arrays]
    step, consts, state = ps.stack_scenes(scenes)
    with torch.no_grad():
        for _ in range(5):
            state = ps.batch_step(step, consts, *state)
    for i, (s, a) in enumerate(zip(scenes, arrays)):
        s.sim_z = state[0][i]
        np.testing.assert_allclose(
            s.get_object_deformed_pts(0)[:sizes[i][0]].numpy(),
            _unpadded_run(a, 5), rtol=1e-4, atol=1e-5, err_msg=str(i))


def test_three_sizes_sharded_on_two_ranks(ranks):
    """4 scenes of 2 sizes on the 2 ranks, 4 steps, against their
    sequential unpadded runs."""
    arrays = ranks["inputs"]["padded"]["arrays"]
    for i, (got, a) in enumerate(zip(ranks["padded"], arrays)):
        np.testing.assert_allclose(got, _unpadded_run(a, 4), rtol=1e-4,
                                   atol=1e-5, err_msg=str(i))


def test_stack_scenes_raises_helpfully_on_mismatch():
    scenes = [workers.scene_of(baked_arrays(0, 40, 3)),
              workers.scene_of(baked_arrays(1, 56, 3))]
    with pytest.raises(ValueError, match="pad_skinned_physics_points"):
        ps.stack_scenes(scenes)


def test_padded_scene_diagnostics_ignore_phantoms():
    scene = workers.scene_of(baked_arrays(1, 48, 3), (90, 5),
                             collisions=True)
    scene.run_sim_step()
    diag = scene.collision_diagnostics()
    assert not bool(diag["cell_overflow"])
    assert int(diag["dropped_points"]) == 0
    assert int(diag["out_of_bounds"]) == 0


def test_phantom_points_move_in_both_packages():
    """F38 (ROADMAP Queue C): ``kaolin_tpu/parallel/simplicits.py:52-57``
    says Newton leaves the phantom handles' DOFs at exactly 0. In both
    packages the phantom points move a little instead (about 1.9e-6 here
    against 0.49 for the real ones, after 10 steps): the Hessian
    regularizer acts in the QR basis, where the phantom columns mix with
    the real ones. The port's phantom displacement stays within 1e-5 of
    max|B z| of JAX's."""
    from kaolin_tpu.physics.simplicits import SimplicitsScene as SceneJax
    arrays = baked_arrays(0, 40, 4)
    jscene = SceneJax(timestep=0.03, max_newton_steps=3, max_ls_steps=5)
    jscene.add_object(pad_jax(PointsJax(**arrays), 64, 6), apply_qr=True,
                      normalize_weights_by_samples=True)
    jscene.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]))
    jscene.set_scene_floor(floor_height=-1.0)
    tscene = workers.scene_of(arrays, (64, 6))
    for _ in range(10):
        jscene.run_sim_step()
        tscene.run_sim_step()
    want = (np.asarray(jscene.sim_B, np.float64)
            @ np.asarray(jscene.sim_z, np.float64)).reshape(-1, 3)
    got = (tscene.sim_B.double() @ tscene.sim_z.double()).reshape(
        -1, 3).numpy()
    scale = np.abs(want[:40]).max()
    assert np.abs(want[40:]).max() > 0 and np.abs(got[40:]).max() > 0
    assert np.abs(want[40:]).max() < 1e-4 * scale
    np.testing.assert_allclose(got[40:], want[40:], rtol=0, atol=1e-5 * scale)
