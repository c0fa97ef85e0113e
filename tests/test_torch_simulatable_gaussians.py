"""The simulatable-gaussians scene of kaolin_tpu_torch against kaolin_tpu's,
on the CPU.

The small scene of ``examples/torch_simulatable_gaussians.py``: 300
gaussians of scale 0.05 on a sphere of radius 0.4 about (0, 0.6, 0), 400
interior points from the port's densifier, 8 handles (``sin(x @
freqs)``), 256 quadrature points, 3 Newton steps, gravity, a floor at 0
and contact. Both packages build it from the same points and frequencies
(JAX's ``SimplicitsObject.create_from_function`` and scene calls, as
``examples/simulatable_gaussians.py`` makes them). JAX's jitted step gives
the states; the port's step is fed JAX's state at each of 5 steps, crossed
through the pre-QR basis in float64, and its displacement B z must lie
within 2e-5 of max|B z| of JAX's next one, and the renderable gaussians
moved by LBS at JAX's states within 1e-5 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.physics.simplicits import PhysicsPoints as PointsJax
from kaolin_tpu.physics.simplicits import SimplicitsObject as ObjectJax
from kaolin_tpu.physics.simplicits import SimplicitsScene as SceneJax
from tests.torch_parity import (  # noqa: F401
    displacement,
    load_example,
    torch_threads_per_worker,
    warm_torch_exp,
    z_converter,
)

sg = load_example("torch_simulatable_gaussians")

STEPS = 5
Z_TOL = 2e-5
PTS_TOL = 1e-5
SMALL = dict(sg.EXAMPLE, num_gaussians=300, scale=0.05)


def jax_scene(xyz, vol_pts, freqs, cfg):
    """``examples/simulatable_gaussians.py``'s scene calls in the JAX
    package, from the given points and frequencies."""
    freqs = jnp.asarray(freqs)
    phys = PointsJax(pts=jnp.asarray(vol_pts), yms=2e5, prs=0.45,
                     rhos=500.0, appx_vol=4 / 3 * np.pi * 0.4 ** 3)
    obj = ObjectJax.create_from_function(phys, lambda x: jnp.sin(x @ freqs))
    scene = SceneJax(timestep=0.03, max_newton_steps=cfg["max_newton_steps"],
                     max_ls_steps=10, direct_solve=cfg["direct_solve"])
    obj_idx = scene.add_object(obj, num_qp=cfg["num_qp"],
                               renderable_pts=jnp.asarray(xyz))
    scene.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]))
    scene.set_scene_floor(floor_height=0.0, floor_penalty=1000.0)
    scene.enable_collisions()
    return scene, obj_idx


@pytest.fixture(scope="module")
def run():
    """Both scenes, JAX's states after 0..5 steps and its renderable
    points at each."""
    port, obj_idx, xyz, vol_pts = sg.build(SMALL, "cpu")
    vol_np = vol_pts.numpy()
    _, rng = sg.shell_gaussians(SMALL["num_gaussians"], SMALL["scale"])
    freqs = rng.randn(3, SMALL["num_handles"] - 1).astype(np.float32)
    js, jidx = jax_scene(xyz, vol_np, freqs, SMALL)
    step = js._build_step_fn()
    state = (js.sim_z, js.sim_z_prev, js.sim_z_dot)
    ovf = jnp.int32(0)
    states, moved = [tuple(np.asarray(x) for x in state)], []
    for _ in range(STEPS):
        *state, ovf = step(*state, ovf)
        states.append(tuple(np.asarray(x) for x in state))
        js.sim_z = state[0]
        moved.append(np.asarray(js.get_object_deformed_pts(
            jidx, points="rendered")))
    return {"port": port, "idx": obj_idx, "jax": js, "states": states,
            "moved": moved, "flags": int(ovf), "vol": vol_np, "xyz": xyz}


def test_scene_matches_jax_scene(run):
    ps, js = run["port"], run["jax"]
    assert run["vol"].shape == (SMALL["num_samples"], 3)
    po, jo = ps.get_object(run["idx"]), js.get_object(0)
    np.testing.assert_array_equal(po.pts.numpy(), np.asarray(jo.pts))
    np.testing.assert_allclose(po.skinning_weights.numpy(),
                               np.asarray(jo.skinning_weights), atol=1e-6)
    np.testing.assert_array_equal(po.renderable.pts.numpy(), run["xyz"])
    np.testing.assert_allclose(po.renderable.skinning_weights.numpy(),
                               np.asarray(jo.renderable.skinning_weights),
                               atol=1e-6)
    cp = ps.force_dict["collision"]["object"]
    cj = js.force_dict["collision"]["object"]
    for name in ("broad_phase", "max_contacts", "collision_radius", "dt"):
        assert getattr(cp, name) == getattr(cj, name), name
    assert run["flags"] == 0


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state(run, step):
    """The port's step from JAX's state against JAX's next state, by B z;
    the renderable gaussians moved by LBS at that state against JAX's."""
    ps, js = run["port"], run["jax"]
    conv = z_converter(ps, js)
    fn, consts = ps.build_functional_step(with_diag=True)
    z_in = [conv(x) for x in run["states"][step]]
    with torch.no_grad():
        z1, zp, _, flags = fn(consts, *z_in)
    want = displacement(js, run["states"][step + 1][0])
    got = displacement(ps, z1)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= Z_TOL * scale
    assert torch.equal(zp, z_in[0]) and int(flags) == 0

    ps.sim_z = conv(run["states"][step + 1][0])
    moved = ps.get_object_deformed_pts(run["idx"], points="rendered")
    np.testing.assert_allclose(moved.numpy(), run["moved"][step],
                               atol=PTS_TOL, rtol=0)


def test_rollout_moves_the_renderable_gaussians(run):
    """``rollout``'s stack of LBS-moved points: one row a step, each the
    scene's renderable points after that step; the shell falls."""
    port, obj_idx, xyz, _ = sg.build(SMALL, "cpu",
                                     vol_pts=torch.from_numpy(run["vol"]))
    moved = sg.rollout(port, obj_idx, 3)
    assert moved.shape == (3,) + xyz.shape
    np.testing.assert_array_equal(
        moved[-1].numpy(),
        port.get_object_deformed_pts(obj_idx, points="rendered").numpy())
    heights = moved[:, :, 1].mean(dim=1)
    assert bool(torch.isfinite(moved).all())
    assert float(heights[-1]) < float(heights[0]) < float(xyz[:, 1].mean())
    tfms = port.get_object_point_transforms(obj_idx, points="rendered")
    assert tfms.shape == (xyz.shape[0], 4, 4)


@pytest.mark.parametrize("make", ["create_from_function", "create_rigid"])
def test_analytic_objects_follow_the_points_device(make):
    """F26: an analytic or rigid object keeps its skinning box on its
    points' device (it stayed on the CPU, and an object on the card failed
    to bake). The meta device stands in for the card here."""
    from kaolin_tpu_torch.physics.simplicits import (
        PhysicsPoints,
        SimplicitsObject,
    )
    def meta(v):
        return torch.full((8,), v, device="meta")

    phys = PhysicsPoints(pts=torch.zeros((8, 3), device="meta"),
                         yms=meta(1e5), prs=meta(0.45), rhos=meta(500.0),
                         appx_vol=1.0)
    args = (phys,) if make == "create_rigid" else (phys, torch.sin)
    obj = getattr(SimplicitsObject, make)(*args)
    assert obj.skinning_mod.bb_min.device.type == "meta"
    w = obj.skinning_mod.compute_skinning_weights(phys.pts)
    assert w.device.type == "meta" and w.shape[0] == 8


def test_bench_config_is_the_bench():
    """``bench_scene``'s numbers are ``bench.py``'s ``bench_gaussians_sim``
    and ``main``'s are ``examples/simulatable_gaussians.py``'s."""
    assert sg.BENCH == dict(num_gaussians=2000, scale=0.05,
                            num_samples=2048, num_handles=16, num_qp=2048,
                            max_newton_steps=5, direct_solve=True,
                            steps=100)
    assert (sg.EXAMPLE["num_gaussians"], sg.EXAMPLE["scale"],
            sg.EXAMPLE["num_samples"], sg.EXAMPLE["num_handles"],
            sg.EXAMPLE["num_qp"], sg.EXAMPLE["steps"]) == (500, 0.06, 400, 8,
                                                           256, 20)
    gaussians, rng = sg.shell_gaussians(2000, 0.05)
    ref = np.random.RandomState(0)
    d = ref.randn(2000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        gaussians[0], (0.4 * d + np.array([0.0, 0.6, 0.0])).astype(
            np.float32))
    np.testing.assert_array_equal(rng.randn(3, 15), ref.randn(3, 15))


def test_tutorial_at_smoke_size():
    """``examples/torch_tutorial_working_with_gaussians.py`` at its smoke
    size on the CPU, with its own asserts."""
    tut = load_example("torch_tutorial_working_with_gaussians")
    gs = tut.main(smoke=True, device="cpu")
    assert len(gs) == 300 and gs.sh_degree == 1
