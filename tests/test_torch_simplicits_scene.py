"""The kaolin_tpu_torch Simplicits sim step against kaolin_tpu's, on the CPU.

Scenes at ``__graft_entry__._make_scene``'s size (256 quadrature points, 9
handles, dt 0.03, 3 Newton and 5 line-search steps, gravity and a floor),
built by both packages from the same numpy points
(``examples/torch_simplicits_drop.py``'s ``graft_points``).

The column-pivoted QR that conditions B picks its pivots among handle norms
that are equal but for rounding, so the two packages may take different
pivots and give z in different bases (JAX sums the norms in float32, the
port in float64). The tests therefore hold quantities
that do not depend on the basis: the displacement B z, the deformed points
and the operators taken back to the pre-QR basis. A state crosses from one
package to the other through that basis, in float64:
z_port = K_port⁻¹ K_jax z_jax.

Trajectories are held step by step from JAX's state: JAX's (z, z_prev,
z_dot) at step t go into the port's step, whose B z at t + 1 must lie
within 2e-5 of max|B z| of JAX's (1e-5 seen; the float32 products and
solves round in other orders, and a line search that decides a near-tie
the other way would show here). A free rollout is compared loosely, by its
mean deformed height.
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import __graft_entry__
from kaolin_tpu.physics.simplicits import SimplicitsScene as SceneJax
from kaolin_tpu.physics.simplicits import SkinnedPhysicsPoints as PointsJax
from kaolin_tpu_torch.physics.common.optimization import newtons_method
from kaolin_tpu_torch.physics.simplicits import SimplicitsScene
from kaolin_tpu_torch.physics.simplicits import simulation
from tests.torch_parity import ROOT, load_example, z_converter
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

STEPS = 20
Z_TOL = 2e-5


def load_drop():
    path = f"{ROOT}/examples/torch_simplicits_drop.py"
    spec = importlib.util.spec_from_file_location("torch_simplicits_drop",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


drop = load_drop()


def jax_scene(points, bc=False, apply_qr=True, init=None):
    """The graft scene in the JAX package; with ``bc`` a pinned top face
    and an initial lift."""
    baked = PointsJax(pts=points["pts"], yms=1e4, prs=0.45, rhos=500.0,
                      appx_vol=1.0, skinning_weights=points["w"],
                      dwdx=points["dwdx"])
    scene = SceneJax(timestep=0.03, max_newton_steps=3, max_ls_steps=5)
    scene.add_object(baked, init_transform=init, apply_qr=apply_qr)
    scene.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]))
    scene.set_scene_floor(floor_height=-1.0)
    if bc:
        scene.set_object_boundary_condition(
            0, "top", lambda x: x[:, 1] > 0.35, bdry_penalty=1000.0)
    return scene


def port_scene(points, bc=False, apply_qr=True, init=None, **kw):
    baked = simulation.SkinnedPhysicsPoints(
        pts=points["pts"], yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
        skinning_weights=points["w"], dwdx=points["dwdx"])
    scene = SimplicitsScene(timestep=0.03, max_newton_steps=3, max_ls_steps=5,
                            device="cpu", **kw)
    scene.add_object(baked, init_transform=init, apply_qr=apply_qr)
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0)
    if bc:
        scene.set_object_boundary_condition(
            0, "top", lambda x: x[:, 1] > 0.35, bdry_penalty=1000.0)
    return scene


def jax_states(scene, n):
    """JAX's (z, z_prev, z_dot) after 0..n steps, as numpy."""
    step = scene._build_step_fn()
    state = (scene.sim_z, scene.sim_z_prev, scene.sim_z_dot)
    ovf = jnp.int32(0)
    out = [tuple(np.asarray(x) for x in state)]
    for _ in range(n):
        *state, ovf = step(*state, ovf)
        out.append(tuple(np.asarray(x) for x in state))
    return out


def t(x):
    return torch.from_numpy(np.array(x))


def qr_blocks(scene, name):
    """The scene's block-diagonal ``qr_tfm`` or ``qr_tfm_inv`` in float64
    (every object of these tests takes the QR)."""
    blocks = [np.asarray(o.qr_tfm if name == "qr_tfm" else o.qr_tfm_inv,
                         np.float64) for o in scene.sim_obj_dict.values()]
    return scipy.linalg.block_diag(*blocks)


def to_port(ps, js):
    """JAX's z (numpy) → the port's z in its own basis, through the pre-QR
    basis in float64."""
    conv = qr_blocks(ps, "qr_tfm_inv") @ qr_blocks(js, "qr_tfm")
    return lambda z: t((conv @ np.asarray(z, np.float64)).astype(np.float32))


def displacement(scene, z):
    """B z in float64: the points' displacement, whatever the basis."""
    return np.asarray(scene.sim_B, np.float64) @ np.asarray(z, np.float64)


def assert_z_close(got, want, tol=Z_TOL):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def graft():
    points = drop.graft_points()
    js = jax_scene(points)
    return {"points": points, "jax": js, "states": jax_states(js, STEPS),
            "port": drop.graft_scene("cpu")}


def test_scene_is_the_graft_scene(graft):
    """The test scene is ``__graft_entry__._make_scene``'s, and both
    packages build the same operators from it: the masses exactly, the
    normalized weights to rounding (the norms sum in another order), and
    B K, dF/dz K and BMB taken back to the pre-QR basis to rounding."""
    ref = __graft_entry__._make_scene()
    np.testing.assert_array_equal(np.asarray(ref.sim_B),
                                  np.asarray(graft["jax"].sim_B))
    sp, sj = graft["port"], graft["jax"]
    po, jo = sp.sim_obj_dict[0], sj.sim_obj_dict[0]
    for name in ("sample_vols", "sample_masses"):
        np.testing.assert_array_equal(getattr(po, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    for name in ("handle_norms", "skinning_weights", "dwdx"):
        want = np.asarray(getattr(jo, name))
        np.testing.assert_allclose(getattr(po, name).numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=name)
    # B K K⁻¹ = B: 5e-7 of the largest entry seen
    kp, kj = qr_blocks(sp, "qr_tfm_inv"), qr_blocks(sj, "qr_tfm_inv")
    for name in ("sim_B", "sim_dFdz"):
        got = np.asarray(getattr(sp, name), np.float64) @ kp
        want = np.asarray(getattr(sj, name), np.float64) @ kj
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * float(np.abs(want).max()),
                                   err_msg=name)
    got = kp.T @ np.asarray(sp.sim_BMB, np.float64) @ kp
    want = kj.T @ np.asarray(sj.sim_BMB, np.float64) @ kj
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * float(np.abs(want).max()))
    assert not sp.sim_z.any() and not np.asarray(sj.sim_z).any()


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state(graft, step):
    """The port's step from JAX's state at ``step`` against JAX's next
    state, as displacements B z and B ż (the latter within 3e-4, 1.2e-4
    seen: ż is a difference over dt); step 0 is the first step of the
    scene."""
    ps, js = graft["port"], graft["jax"]
    fn, consts = ps.build_functional_step()
    conv = to_port(ps, js)
    z_in = [conv(x) for x in graft["states"][step]]
    want = graft["states"][step + 1]
    got = fn(consts, *z_in)
    assert_z_close(displacement(ps, got[0]), displacement(js, want[0]))
    assert torch.equal(got[1], z_in[0])
    assert_z_close(displacement(ps, got[2]), displacement(js, want[2]),
                   tol=3e-4)


def test_free_rollout_height_matches_jax(graft):
    """30 steps each package on its own: the mean deformed height within
    1e-3, after a fall of about half a unit onto the floor."""
    js = jax_scene(graft["points"])
    ps = drop.graft_scene("cpu")
    h0 = drop.mean_height(ps)
    js.run_sim_steps(30)
    ps.run_sim_steps(30)
    want = float(jnp.mean(js.get_object_deformed_pts(0)[:, 1]))
    got = drop.mean_height(ps)
    assert abs(got - want) <= 1e-3
    assert got < h0 - 0.3 and got > -1.0
    want = np.asarray(js.get_object_transforms(0))
    np.testing.assert_allclose(ps.get_object_transforms(0).numpy(), want,
                               atol=5e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("apply_qr", [True, False])
def test_boundary_condition_scene_matches_jax(apply_qr):
    """A pinned top face and an initial lift, with and without the QR
    rotation: the pins the same, and 5 steps each from JAX's state, held
    by the displacement B z within 1e-4 of its largest entry (4e-5 seen
    either way: the stiff pins amplify rounding more than the free fall).

    Without the rotation BMB's condition number is about 2.6e9, beyond
    what a float32 solve resolves: z is then decided by rounding along its
    weakest directions (the two packages' z part by up to 8e-4 of max|z|),
    which barely move the points. So there z (one basis then) is held only
    to 1e-3."""
    points = drop.graft_points()
    init = np.eye(4, dtype=np.float32)
    init[1, 3] = 0.1
    js = jax_scene(points, bc=True, apply_qr=apply_qr, init=init)
    ps = port_scene(points, bc=True, apply_qr=apply_qr, init=init)
    pin_j = js.force_dict["pt_wise"]["top"]["object"]
    pin_p = ps.force_dict["pt_wise"]["top"]["object"]
    np.testing.assert_array_equal(pin_p.pin_mask.numpy(),
                                  np.asarray(pin_j.pin_mask))
    np.testing.assert_allclose(pin_p.pin_pos.numpy(),
                               np.asarray(pin_j.pin_pos), atol=1e-6)
    assert 0 < int(pin_p.pin_mask.sum()) < 256
    states = jax_states(js, 5)
    np.testing.assert_allclose(displacement(ps, ps.sim_z),
                               displacement(js, states[0][0]), atol=1e-6)
    fn, consts = ps.build_functional_step()
    conv = to_port(ps, js) if apply_qr else t
    for s in range(5):
        got = fn(consts, *(conv(x) for x in states[s]))
        want = states[s + 1][0]
        assert_z_close(displacement(ps, got[0]), displacement(js, want),
                       tol=1e-4)
        if not apply_qr:
            assert_z_close(got[0], want, tol=1e-3)
    np.testing.assert_allclose(
        ps.get_object_deformed_pts(0).numpy(),
        np.asarray(js.get_object_deformed_pts(0)), atol=1e-5)


def test_run_sim_steps_equals_single_steps():
    a, b = drop.graft_scene("cpu"), drop.graft_scene("cpu")
    a.run_sim_steps(6)
    for _ in range(6):
        b.run_sim_step()
    assert a.current_sim_step == b.current_sim_step == 6
    for x, y in ((a.sim_z, b.sim_z), (a.sim_z_prev, b.sim_z_prev),
                 (a.sim_z_dot, b.sim_z_dot)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_fixed_trip_equals_early_exit():
    """Newton's fixed trip (the CUDA graph's loop, ``differentiable=True``)
    and the early-exit loop give z bit for bit over 10 steps, and the
    early exit did stop early."""
    early = drop.graft_scene("cpu")
    fixed = drop.graft_scene("cpu", differentiable=True)
    before = newtons_method.iterations
    early.run_sim_steps(10)
    ran = newtons_method.iterations - before
    fixed.run_sim_steps(10)
    assert ran < 10 * 3
    assert newtons_method.iterations - before - ran == 10 * 3
    for x, y in ((early.sim_z, fixed.sim_z),
                 (early.sim_z_dot, fixed.sim_z_dot)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_scene_state_queries_match_jax(graft):
    """Initial transforms, reset and the per-point transforms."""
    points = graft["points"]
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = (0.1, 0.2, -0.1)
    js, ps = jax_scene(points), port_scene(points)
    js.set_object_initial_transform(0, init)
    ps.set_object_initial_transform(0, init)
    np.testing.assert_allclose(ps.get_object_transforms(0).numpy(),
                               np.asarray(js.get_object_transforms(0)),
                               atol=1e-5)
    np.testing.assert_allclose(
        ps.get_object_point_transforms(0).numpy(),
        np.asarray(js.get_object_point_transforms(0)), atol=1e-5)
    ps.run_sim_step()
    with pytest.raises(ValueError, match="mid-simulation"):
        ps.set_object_initial_transform(0, init)
    with pytest.raises(ValueError, match="not kinematic"):
        ps.set_kinematic_object_transform(0, init)
    ps.reset_scene()
    assert ps.current_sim_step == 0
    np.testing.assert_allclose(displacement(ps, ps.sim_z),
                               displacement(js, js.sim_z), atol=1e-6)


def test_scene_needs_a_device(monkeypatch):
    """No CUDA device and no device: the scene raises, it does not fall
    back to the CPU. Graphs need CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimplicitsScene()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drop.config1_scene(None)
    with pytest.raises(ValueError, match="CUDA"):
        SimplicitsScene(device="cpu", use_cuda_graphs=True)
    assert SimplicitsScene(device="cpu").device == torch.device("cpu")


PAD_STEPS = 8


def padded_demo_points(seed=3, num_qp=48, kinematic_qp=25):
    """``make_demo_scene``'s soft body (48 points, 3 handles) and kinematic
    plate (25 points) from its numpy draws, each padded by the JAX
    package's ``pad_skinned_physics_points`` (to 80 points and 5 handles,
    and to 36 points): [(arrays, padded arrays)] as numpy."""
    from kaolin_tpu.parallel.simplicits import pad_skinned_physics_points
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (num_qp, 3)).astype(np.float32)
    freqs = rng.randn(3, 2).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs), np.ones((num_qp, 1),
                                                     np.float32)], axis=1)
    dwdx = np.zeros((num_qp, 3, 3), np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    g = np.linspace(-0.6, 0.6, 5)
    gx, gz = np.meshgrid(g, g)
    kpts = np.stack([gx.ravel(), np.full(25, -0.85), gz.ravel()],
                    axis=1)[:kinematic_qp].astype(np.float32)
    soft = dict(pts=pts, yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
                skinning_weights=w, dwdx=dwdx)
    plate = dict(pts=kpts, yms=1e5, prs=0.45, rhos=1000.0, appx_vol=0.1,
                 skinning_weights=np.ones((kinematic_qp, 1), np.float32),
                 dwdx=np.zeros((kinematic_qp, 1, 3), np.float32))
    out = []
    for arrays, qp, handles in ((soft, 80, 5), (plate, 36, 1)):
        padded = pad_skinned_physics_points(PointsJax(**arrays), qp, handles)
        out.append((arrays, {
            "pts": padded.pts, "yms": padded.yms, "prs": padded.prs,
            "rhos": padded.rhos, "appx_vol": padded.appx_vol,
            "skinning_weights": padded.skinning_weights,
            "dwdx": padded.dwdx, "num_real_qp": padded.num_real_qp}))
    return [(a, {k: v if np.isscalar(v) or v is None else np.array(v)
                 for k, v in p.items()}) for a, p in out]


def demo_with_contact(scene, objects, on_jax):
    """The demo scene's set-up on ``scene`` from ``objects`` (keyword
    arrays): the soft body with the QR, the plate kinematic, gravity, a
    floor and grid contact of radius 0.15 (K = 32, M = 512)."""
    cls = PointsJax if on_jax else simulation.SkinnedPhysicsPoints
    for arrays, kin in zip(objects, (False, True)):
        scene.add_object(cls(**arrays), is_kinematic=kin, apply_qr=not kin,
                         normalize_weights_by_samples=not kin)
    scene.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]) if on_jax
                            else (0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0)
    scene.enable_collisions(collision_particle_radius=0.15,
                            max_contact_pairs=512, broad_phase="grid",
                            cell_capacity=32, max_occupied_cells=512)
    return scene


@pytest.fixture(scope="module")
def padded():
    """The padded demo scene in both packages, JAX's states over
    ``PAD_STEPS`` steps, and the port's unpadded scene."""
    objs = padded_demo_points()
    js = demo_with_contact(SceneJax(timestep=0.03, max_newton_steps=3,
                                    max_ls_steps=5), [p for _, p in objs],
                           True)
    ps = demo_with_contact(SimplicitsScene(timestep=0.03, max_newton_steps=3,
                                           max_ls_steps=5, device="cpu"),
                           [p for _, p in objs], False)
    ref = demo_with_contact(SimplicitsScene(timestep=0.03,
                                            max_newton_steps=3,
                                            max_ls_steps=5, device="cpu"),
                            [a for a, _ in objs], False)
    return {"jax": js, "port": ps, "unpadded": ref,
            "states": jax_states(js, PAD_STEPS)}


def test_collisions_are_not_ported(padded):
    """Contact of padded objects, which the port once refused, against
    JAX's padded scene: the soft body's and the plate's phantom points
    (``num_real_qp``) are left out of detection and of the grid's sizing,
    and the port's step from JAX's state at each of 8 steps gives B z
    within 2e-5 of max|B z| of JAX's next state, with the same contact
    count and no overflow. A scene without forces does not step."""
    ps, js = padded["port"], padded["jax"]
    cp = ps.force_dict["collision"]["object"]
    cj = js.force_dict["collision"]["object"]
    assert cp.grid_dims == cj.grid_dims
    np.testing.assert_array_equal(cp.grid_origin, np.asarray(cj.grid_origin))
    np.testing.assert_array_equal(ps.qp_is_phantom.numpy(),
                                  np.asarray(js.qp_is_phantom))
    assert int(ps.qp_is_phantom.sum()) == 32 + 11
    assert not ps._collision_provably_empty()
    fn, consts = ps.build_functional_step(with_diag=True)
    conv = z_converter(ps, js)
    for s in range(PAD_STEPS):
        z_in = [conv(x) for x in padded["states"][s]]
        with torch.no_grad():
            z1, _, _, flags = fn(consts, *z_in)
        assert int(flags) == 0
        assert_z_close(displacement(ps, z1),
                       displacement(js, padded["states"][s + 1][0]))
    with pytest.raises(RuntimeError, match="Forces"):
        SimplicitsScene(device="cpu").run_sim_step()


def test_padded_contact_matches_unpadded(padded):
    """The port's padded scene with contact steps as the unpadded one: the
    real points' deformed positions after 8 free steps within the JAX
    package's own padded-scene tolerance (1e-4 relative, 1e-5 absolute),
    with contacts found at every step."""
    import copy
    ps, ref = copy.deepcopy(padded["port"]), copy.deepcopy(
        padded["unpadded"])
    for _ in range(PAD_STEPS):
        assert int(ps.collision_diagnostics()["num_pairs"]) > 0
        ps.run_sim_step()
        ref.run_sim_step()
    for obj, n in ((0, 48), (1, 25)):
        np.testing.assert_allclose(
            ps.get_object_deformed_pts(obj).numpy()[:n],
            ref.get_object_deformed_pts(obj).numpy(), rtol=1e-4, atol=1e-5)


def test_padded_contact_diagnostics_match_jax(padded):
    """The padded scene's diagnostics at JAX's state after each step equal
    JAX's: the same pair count, and no footprint of the far-away phantom
    points (no cell overflow, dropped or out-of-bounds point)."""
    ps, js = padded["port"], padded["jax"]
    conv = z_converter(ps, js)
    for s in (0, PAD_STEPS // 2, PAD_STEPS):
        z = padded["states"][s][0]
        js.sim_z = jnp.asarray(z)
        ps.sim_z = conv(z)
        want = {k: int(v) for k, v in js.collision_diagnostics().items()}
        got = {k: int(v) for k, v in ps.collision_diagnostics().items()}
        assert got == want, (s, got, want)
        assert got["num_pairs"] > 0
        assert got["cell_overflow"] == got["dropped_points"] == 0
        assert got["out_of_bounds"] == 0
    ps.reset_scene()
    js.reset_scene()


def test_example_pads_as_jax(padded):
    """``examples/torch_collision_stack.py``'s ``pad_points`` (which
    ``chip_smoke.py`` pads with, as it imports no JAX) gives JAX's padded
    arrays bit for bit, and its padded demo scene is this module's."""
    stack = load_example("torch_collision_stack")
    for arrays, want in padded_demo_points():
        got = stack.pad_points(arrays, want["pts"].shape[0],
                               want["skinning_weights"].shape[1])
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    scene = stack.demo_scene("cpu", 3, num_qp=48, kinematic_qp=25,
                             max_contact_pairs=512, pad=(80, 5, 36))
    ps = padded["port"]
    for name in ("sim_pts", "sim_B", "sim_masses", "qp_is_phantom"):
        assert torch.equal(getattr(scene, name), getattr(ps, name)), name


def test_config1_scene_shapes_on_the_cpu():
    """Config 1 builds at its published size (1,000 points, 33 handles,
    396 DOFs) and takes a step on the CPU; its weights and gradients
    against ``bench.py``'s synthetic skinning, run through the JAX
    package."""
    import bench
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (1000, 3)).astype(np.float32)
    want = bench._synthetic_skinned_points(rng, pts, 33)
    got = drop.config1_points()
    np.testing.assert_array_equal(got["pts"], np.asarray(want.pts))
    np.testing.assert_allclose(got["w"], np.asarray(want.skinning_weights),
                               atol=1e-6)
    np.testing.assert_allclose(got["dwdx"], np.asarray(want.dwdx), atol=2e-3)
    scene = drop.config1_scene("cpu")
    assert scene.sim_B.shape == (3000, 396)
    assert scene.sim_dFdz.shape == (9000, 396)
    h0 = drop.mean_height(scene)
    scene.run_sim_step()
    assert bool(torch.isfinite(scene.sim_z).all())
    assert drop.mean_height(scene) < h0



def test_two_objects_one_kinematic_match_jax():
    """Two objects, the second kinematic and lifted: block-diagonal
    operators, its DOFs held out of Newton; 4 steps each from JAX's state,
    then a scripted move of the kinematic object."""
    a = drop.graft_points(num_qp=64, num_handles=4)
    b = drop.graft_points(num_qp=48, num_handles=3)
    b["pts"] = b["pts"] * np.float32(0.5)
    lift = np.eye(4, dtype=np.float32)
    lift[1, 3] = -0.6

    js = SceneJax(timestep=0.03, max_newton_steps=3, max_ls_steps=5)
    ps = SimplicitsScene(timestep=0.03, max_newton_steps=3, max_ls_steps=5,
                         device="cpu")
    for scene, cls in ((js, PointsJax), (ps, simulation.SkinnedPhysicsPoints)):
        for p, kin, init in ((a, False, None), (b, True, lift)):
            scene.add_object(cls(pts=p["pts"], yms=1e4, prs=0.45,
                                 rhos=500.0, appx_vol=1.0,
                                 skinning_weights=p["w"], dwdx=p["dwdx"]),
                             is_kinematic=kin, init_transform=init)
    js.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]))
    ps.set_scene_gravity((0.0, 9.8, 0.0))
    np.testing.assert_array_equal(ps.dyn_idx, js.dyn_idx)
    assert ps.total_dofs == 12 * 7 and len(ps.dyn_idx) == 12 * 4
    states = jax_states(js, 4)
    fn, consts = ps.build_functional_step()
    conv = to_port(ps, js)
    for s in range(4):
        z_in = [conv(x) for x in states[s]]
        got = fn(consts, *z_in)
        assert_z_close(displacement(ps, got[0]),
                       displacement(js, states[s + 1][0]))
        assert torch.equal(got[0][48:], z_in[0][48:])
    move = np.eye(4, dtype=np.float32)
    move[0, 3] = 0.2
    js.set_kinematic_object_transform(1, move)
    ps.set_kinematic_object_transform(1, move)
    np.testing.assert_allclose(displacement(ps, ps.sim_z),
                               displacement(js, js.sim_z), atol=1e-6)
    np.testing.assert_allclose(ps.get_object_deformed_pts(1).numpy(),
                               np.asarray(js.get_object_deformed_pts(1)),
                               atol=1e-5)
