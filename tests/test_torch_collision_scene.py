"""The kaolin_tpu_torch Simplicits scene with contact against kaolin_tpu's,
on the CPU.

The scenes are ``kaolin_tpu.parallel.simplicits.make_demo_scene``'s: a soft
body of 48 points (3 handles, QR) falling onto a kinematic plate of 25
points, contact radius 0.15, 512 contact pairs, built by the port from the
same numpy draws (``tests/torch_parity.py::demo_scene``). JAX's jitted
step gives the states; the port's step is fed JAX's state at each step,
crossed through the pre-QR basis in float64, and its displacement B z at
the next step must lie within 2e-5 of max|B z| of JAX's, as in
``tests/test_torch_simplicits_scene.py``, plus twice the port's own spread
under a relative change of its input z by ±1e-7 and ±2e-7. Dense and grid
take 10 steps, the sweep 5.

That spread is about 2e-6 of max|B z| at most steps; at step 9 of the
dense scene it is 3e-5 to 1.1e-4: the body's contacts press into the
barrier, the third Newton direction turns with the last bits of z (the log
barrier's second derivative grows as 1/dp², and the Hessian, not symmetric
with friction, is factored by Cholesky or LU as those bits fall), no step
size passes Armijo and the search takes its smallest. JAX's state there
lies 1.0e-4 away, within that spread. A fault of the port would show at the
other steps, where the spread is small.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from kaolin_tpu.parallel.simplicits import make_demo_scene
from kaolin_tpu.physics.common.collisions import Collision as CollisionJax
from kaolin_tpu.physics.simplicits import SimplicitsScene as SceneJax
from kaolin_tpu.physics.simplicits import SkinnedPhysicsPoints as PointsJax
from kaolin_tpu.physics.simplicits.precomputed import (
    lbs_matrix as lbs_matrix_jax,
)
from kaolin_tpu_torch.physics.common import Collision
from kaolin_tpu_torch.physics.simplicits import (
    SimplicitsScene,
    SkinnedPhysicsPoints,
)
from tests.torch_parity import displacement, load_example, z_converter
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

Z_TOL = 2e-5
STEPS = {"dense": 10, "grid": 10, "sweep": 5}
DEMO = dict(num_qp=48, kinematic_qp=25, with_kinematic=True,
            max_contact_pairs=512)

stack = load_example("torch_collision_stack")


def demo_scene(seed, **kw):
    """The port's ``make_demo_scene`` scene, on the CPU."""
    return stack.demo_scene("cpu", seed, **kw)


def jax_states(scene, n):
    """JAX's (z, z_prev, z_dot) after 0..n steps and each step's overflow
    flags, as numpy."""
    step = scene._build_step_fn()
    state = (scene.sim_z, scene.sim_z_prev, scene.sim_z_dot)
    out, flags = [tuple(np.asarray(x) for x in state)], []
    for _ in range(n):
        *state, ovf = step(*state, jnp.int32(0))
        out.append(tuple(np.asarray(x) for x in state))
        flags.append(int(ovf))
    return out, flags


@pytest.fixture(scope="module")
def runs():
    """Each broad phase's JAX scene, its states and the port's scene, made
    on first use and shared by the module's tests."""
    cache = {}

    def get(bp):
        if bp not in cache:
            js = make_demo_scene(3, broad_phase=bp, **DEMO)
            states, flags = jax_states(js, STEPS[bp])
            cache[bp] = {"bp": bp, "jax": js, "states": states,
                         "flags": flags,
                         "port": demo_scene(3, broad_phase=bp, **DEMO)}
        return cache[bp]
    return get


@pytest.mark.parametrize("bp", list(STEPS))
def test_scene_matches_jax_scene(runs, bp):
    """The same contact configuration: broad phase, capacities and grid
    geometry, the scene's per-point object ids and kinematic flags."""
    run = runs(bp)
    ps, js = run["port"], run["jax"]
    cp = ps.force_dict["collision"]["object"]
    cj = js.force_dict["collision"]["object"]
    for name in ("broad_phase", "max_contacts", "cell_capacity",
                 "max_occupied_cells", "point_contact_capacity",
                 "sweep_window", "grid_dims", "grid_cell", "dt",
                 "collision_radius", "collision_barrier_ratio"):
        assert getattr(cp, name) == getattr(cj, name), name
    if cj.grid_origin is not None:
        np.testing.assert_array_equal(cp.grid_origin,
                                      np.asarray(cj.grid_origin))
    np.testing.assert_array_equal(ps.qp_to_object_map.numpy(),
                                  np.asarray(js.qp_to_object_map))
    np.testing.assert_array_equal(ps.qp_is_kinematic.numpy(),
                                  np.asarray(js.qp_is_kinematic))
    assert not ps._collision_provably_empty()
    assert ps.collision_resize_interval == js.collision_resize_interval == 16


@pytest.mark.parametrize("bp,step", [(bp, k) for bp, n in STEPS.items()
                                     for k in range(n)])
def test_step_from_jax_state(runs, bp, step):
    """The port's step from JAX's state against JAX's next state, by B z,
    with the same overflow flags (0) and contacts found."""
    run = runs(bp)
    ps, js = run["port"], run["jax"]
    conv = z_converter(ps, js)
    fn, consts = ps.build_functional_step(with_diag=True)
    z_in = [conv(x) for x in run["states"][step]]
    with torch.no_grad():
        z1, zp, _, flags = fn(consts, *z_in)
    want = displacement(js, run["states"][step + 1][0])
    got = displacement(ps, z1)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if err > Z_TOL * scale:
        with torch.no_grad():
            spread = max(float(np.abs(displacement(ps, fn(
                consts, z_in[0] * (1 + e), *z_in[1:])[0]) - got).max())
                for e in (1e-7, -1e-7, 2e-7, -2e-7))
        assert err <= Z_TOL * scale + 2 * spread, (err, spread, scale)
    assert torch.equal(zp, z_in[0])
    assert int(flags) == run["flags"][step] == 0
    col = consts["collision"]
    dx = (ps.sim_B @ z_in[0]).reshape(-1, 3)
    c = col.detect_collisions(dx, ps.sim_pts, ps.qp_to_object_map,
                              ps.qp_is_kinematic)
    assert int(c.valid.sum()) > 0


def auto_choice(scene):
    col = scene.force_dict["collision"]["object"]
    return (col.broad_phase, col.cell_capacity, col.max_occupied_cells,
            col.grid_dims, col.point_contact_capacity, col.max_contacts)


def spread_scene(make, points_cls, num_qp, scale, seed=0, radius=0.1,
                 **scene_kw):
    """``tests/physics/test_collisions.py``'s ``_spread_scene`` in either
    package: ``num_qp`` points uniform in a box of side ``scale``, one
    rigid handle, gravity, contact at the auto broad phase."""
    rng = np.random.RandomState(seed)
    pts = (rng.uniform(-0.5, 0.5, (num_qp, 3)) * scale).astype(np.float32)
    body = points_cls(pts=pts, yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
                      skinning_weights=np.ones((num_qp, 1), np.float32),
                      dwdx=np.zeros((num_qp, 1, 3), np.float32))
    scene = make(timestep=0.03, max_newton_steps=2, max_ls_steps=3,
                 **scene_kw)
    scene.add_object(body, apply_qr=False)
    scene.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]) if make is SceneJax
                            else (0.0, 9.8, 0.0))
    scene.enable_collisions(collision_particle_radius=radius,
                            broad_phase=None)
    return scene


def test_auto_broad_phase_matches_jax():
    """``enable_collisions``' auto rule on the JAX file's cases: dense
    below the threshold; 2,048 points packed in a unit box (the grid's
    M·14·K² against N²); the same count spread over a box 20 times larger
    (the grid)."""
    thresh = SimplicitsScene.GRID_BROAD_PHASE_THRESHOLD
    assert thresh == SceneJax.GRID_BROAD_PHASE_THRESHOLD == 2048
    cases = [dict(seed=0, num_qp=32, with_kinematic=True),
             dict(seed=0, num_qp=thresh, with_kinematic=False,
                  max_contact_pairs=4000)]
    for kw in cases:
        seed = kw.pop("seed")
        want = auto_choice(make_demo_scene(seed, broad_phase=None, **kw))
        got = auto_choice(demo_scene(seed, broad_phase=None, **kw))
        assert got == want, kw
    assert auto_choice(demo_scene(0, num_qp=32, broad_phase=None))[0] \
        == "dense"
    want = auto_choice(spread_scene(SceneJax, PointsJax, thresh, 20.0))
    got = auto_choice(spread_scene(SimplicitsScene, SkinnedPhysicsPoints,
                                   thresh, 20.0, device="cpu"))
    assert got == want and got[0] == "grid"


def test_sweep_window_is_jax_auto_window():
    js = make_demo_scene(1, broad_phase="sweep", **DEMO)
    ps = demo_scene(1, broad_phase="sweep", **DEMO)
    assert ps._auto_sweep_window(0.15, 1.5) == js._auto_sweep_window(0.15,
                                                                     1.5)
    assert ps.force_dict["collision"]["object"].sweep_window == \
        js.force_dict["collision"]["object"].sweep_window


def test_provably_empty_scene_skips_detection():
    """One object whose rest diagonal² is under the self-immunity bound
    can never make a contact: the port proves it as JAX does, and its
    steps equal the steps without contact bit for bit. Two objects, or a
    body spread wider than the bound, keep detection."""
    kw = dict(num_qp=40, with_kinematic=False, broad_phase="dense")
    assert make_demo_scene(5, **kw)._collision_provably_empty()
    on = demo_scene(5, **kw)
    off = demo_scene(5, with_collision=False, **kw)
    assert on._collision_provably_empty()
    for _ in range(6):
        on.run_sim_step()
        off.run_sim_step()
    assert torch.equal(on.sim_z, off.sim_z)
    two = demo_scene(5, num_qp=40, with_kinematic=True, broad_phase="dense")
    assert not two._collision_provably_empty()
    assert not make_demo_scene(5, num_qp=40, with_kinematic=True,
                               broad_phase="dense")._collision_provably_empty()
    huge = spread_scene(SimplicitsScene, SkinnedPhysicsPoints, 64, 300.0,
                        radius=0.001, device="cpu")
    assert not huge._collision_provably_empty()


@pytest.mark.parametrize("broad_phase", ["dense", "grid"])
def test_forced_overflow_resizes_as_jax(broad_phase):
    """A 2-pair buffer (7 pairs at rest): at rest both packages report the
    same flags, and resized from them both grow to the same capacities
    (the contact buffer doubled to at least 1,024; the grid re-measured
    with headroom).
    In the port a step sets the flag on the device, the check reads it,
    resizes once, and the next steps drop nothing."""
    kw = dict(DEMO, max_contact_pairs=2)
    js = make_demo_scene(3, broad_phase=broad_phase, **kw)
    ps = demo_scene(3, broad_phase=broad_phase, **kw)
    cj = js.force_dict["collision"]["object"]
    want = int(jax.jit(lambda: CollisionJax.diag_flags(
        cj.detection_diagnostics(
            jnp.zeros_like(js.sim_pts), js.sim_pts, js.qp_to_object_map,
            js.qp_is_kinematic)))())
    got = int(Collision.diag_flags(ps.collision_diagnostics()))
    assert got == want and got & Collision.FLAG_CONTACTS_OVERFLOW
    js._col_overflow = jnp.int32(want)
    ps._col_overflow = torch.tensor(got, dtype=torch.int32)
    with warns_if_grid(broad_phase):
        assert ps.check_collision_capacity() == got
    js.check_collision_capacity()
    assert auto_choice(ps) == auto_choice(js)
    assert ps.force_dict["collision"]["object"].max_contacts == 1024
    assert ps.collision_resizes == js.collision_resizes == 1

    fresh = demo_scene(3, broad_phase=broad_phase, **kw)
    fresh.run_sim_step()
    flags = int(fresh._flags())
    assert flags & Collision.FLAG_CONTACTS_OVERFLOW
    with warns_if_grid(broad_phase):
        assert fresh.check_collision_capacity() == flags
    assert fresh.force_dict["collision"]["object"].max_contacts == 1024
    assert fresh._step_fn is None and fresh._col_overflow is None
    fresh.run_sim_steps(2)
    assert fresh.collision_resizes == 1 and int(fresh._flags()) == 0


def warns_if_grid(broad_phase):
    """A grid resize warns with the old and new sizes; the others do not."""
    return (pytest.warns(UserWarning, match="re-measured")
            if broad_phase == "grid" else contextlib.nullcontext())


def test_run_sim_step_checks_capacity_every_16_steps():
    """Auto-resize reads the flag at step 16, not before; off, it never
    does."""
    kw = dict(DEMO, max_contact_pairs=2)
    scene = demo_scene(3, broad_phase="dense", **kw)
    held = demo_scene(3, broad_phase="dense", **kw)
    held.collision_auto_resize = False
    for k in range(16):
        scene.run_sim_step()
        held.run_sim_step()
        assert scene.collision_resizes == (1 if k == 15 else 0)
    assert held.collision_resizes == 0
    assert int(held._flags()) & Collision.FLAG_CONTACTS_OVERFLOW


def test_example_scene_builders_on_the_cpu():
    """``examples/torch_collision_stack.py``'s builders at a smoke size:
    bench's scene (2 cubes of 200 points, 3 handles, a 16-point plate) and
    the stack (2 cubes of 60, a 5 x 5 plate) find contacts at rest and
    take a finite step down; bench's at 2,216 points takes the grid."""
    bench = stack.collision_10k_scene("cpu", 2, 200, 3, 16)
    assert bench.total_qp == 416 and bench.total_dofs == 12 * (3 + 3 + 1)
    assert list(bench.dyn_idx) == list(range(72))
    pile = stack.stack_scene("cpu", 2, 60, plate_side=5)
    assert pile.total_qp == 145 and pile.max_ls_steps == 20
    for scene in (bench, pile):
        assert int(scene.collision_diagnostics()["num_pairs"]) > 0
        h0 = stack.mean_height(scene)
        scene.run_sim_step()
        assert bool(torch.isfinite(scene.sim_z).all())
        assert stack.mean_height(scene) < h0
    big = stack.collision_10k_scene("cpu", 2, 1100, 3, 16)
    assert big.total_qp == 2216
    assert big.force_dict["collision"]["object"].broad_phase == "grid"


def test_stack_weights_match_jax_create_from_function():
    """The stack's cubes are skinned through ``create_from_function`` as in
    ``examples/collision_stack.py``: the baked weights and their gradients
    as the JAX package's from the same draws."""
    from kaolin_tpu.physics.simplicits import PhysicsPoints as PhysJax
    from kaolin_tpu.physics.simplicits import SimplicitsObject as ObjJax

    pile = stack.stack_scene("cpu", 1, 50, plate_side=3)
    rng = np.random.RandomState(0)
    pts = (stack.ring_center(0)
           + rng.uniform(-0.25, 0.25, (50, 3))).astype(np.float32)
    freqs = jnp.asarray(rng.randn(3, 5).astype(np.float32))
    obj = ObjJax.create_from_function(
        PhysJax(pts=jnp.asarray(pts), yms=1e4, prs=0.45, rhos=500.0,
                appx_vol=0.125), lambda x: jnp.sin(x @ freqs))
    baked = obj.bake(num_qps=50)
    ours = pile.get_object(0)
    np.testing.assert_array_equal(ours.pts.numpy(), np.asarray(baked.pts))
    norms = ours.handle_norms
    np.testing.assert_allclose((ours.skinning_weights * norms).numpy(),
                               np.asarray(baked.skinning_weights), atol=1e-6)
    np.testing.assert_allclose((ours.dwdx * norms[None, :, None]).numpy(),
                               np.asarray(baked.dwdx), atol=1e-5)


def test_sim_b_raw_is_the_pre_qr_operator(runs):
    """``sim_B_raw`` is the block-diagonal raw LBS operator, JAX's objects'
    ``lbs_matrix`` blocks to rounding, and ``sim_B_raw`` times the QR
    rotation is ``sim_B``. (JAX's own ``sim_B_raw`` raises a NameError: it
    calls a function local to ``_compute_sim_constants``.)"""
    run = runs("dense")
    ps, js = run["port"], run["jax"]
    want = scipy.linalg.block_diag(*(
        np.asarray(lbs_matrix_jax(o.pts, o.skinning_weights))
        for o in js.sim_obj_dict.values()))
    raw = ps.sim_B_raw
    assert raw is ps.sim_B_raw
    np.testing.assert_allclose(raw.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose((raw @ ps.sim_qr_tfm).numpy(),
                               ps.sim_B.numpy(), rtol=0, atol=1e-5)


def test_contact_scenes_need_a_device(monkeypatch):
    """Without a card and without ``device`` the example's scenes raise;
    they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (stack.collision_10k_scene, stack.stack_scene):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)


def test_stack_step_is_decided_by_rounding_in_both_packages():
    """The example's stack at 2 x 300 points over a 10 x 10 plate: the QR
    rotations of its cubes have entries of 2e3 and above 1e4 (sin(x·f)
    over a cube of side 0.5 leaves B's columns nearly dependent), the JAX
    package's the same to 1e-3 from the same baked points, so the contact
    Hessian in z's basis is a float32 cancellation; a change of z by 1e-7
    of its size moves even one Newton iteration of the port's step by a
    large share of max|B z|. That is why the card is held to the CPU on
    this scene's contact terms, not on its step (``chip_smoke.py``'s
    ``check_stack_step``)."""
    from kaolin_tpu.physics.simplicits.simulation import (
        SimulatedObject as ObjectJax,
    )

    ps = stack.stack_scene("cpu", 2, 300, plate_side=10)
    rotations = []
    for o in list(ps.sim_obj_dict.values())[:2]:
        w = (o.skinning_weights * o.handle_norms).numpy()
        dwdx = (o.dwdx * o.handle_norms[None, :, None]).numpy()
        oj = ObjectJax(pts=o.pts.numpy(), yms=o.yms.numpy(),
                       prs=o.prs.numpy(), rhos=o.rhos.numpy(),
                       appx_vol=o.appx_vol, skinning_weights=w, dwdx=dwdx,
                       normalize_weights_by_samples=True, apply_qr=True)
        want = float(np.abs(np.asarray(oj.qr_tfm)).max())
        got = float(o.qr_tfm.abs().max())
        assert abs(got - want) <= 1e-3 * want
        rotations.append(got)
    assert max(rotations) > 1e4
    ps.max_newton_steps = 1
    fn, consts = ps.build_functional_step()
    z = (ps.sim_z, ps.sim_z_prev, ps.sim_z_dot)
    u = torch.from_numpy(np.random.RandomState(0).choice(
        [-1.0, 1.0], ps.total_dofs).astype(np.float32))
    with torch.no_grad():
        out = fn(consts, *z)[0]
        base, size = displacement(ps, out), float(out.abs().max())
        spread = max(float(np.abs(displacement(ps, fn(
            consts, z[0] + e * size * u, *z[1:])[0]) - base).max())
            for e in (1e-7, -1e-7))
    assert spread > 0.05 * float(np.abs(base).max())
