"""kaolin_tpu_torch.experimental.newton against kaolin_tpu's, on the CPU.

Mirrors ``tests/physics/test_newton_bridge.py`` as parity: the same numpy
inputs go to both packages. ``detect`` within 1e-6 of max|x| (points inside
the box, on a tie of two gaps and at a sphere's centre among them); the
force's energy within 1e-5 relative, its gradient and Hessian within 1e-5 of
their max|x|; the coupled rollouts' displacements B z (the particles less
their rest positions: the port's QR may pick other pivots than JAX's, so z
is compared through B z) within 2e-5 of max|B z| at every step but two
named ones, where an Armijo decision falls on float32 rounding, plus JAX's
own asserts; a differentiable step's gradient within 1e-4 of max|g| of
``jax.grad``'s, by the velocity in the raw (pre-QR) basis both packages
share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import kaolin_tpu.experimental.newton as jn
from kaolin_tpu.experimental.newton.shapes import BOX, PLANE, SPHERE
from kaolin_tpu.physics.simplicits import SkinnedPhysicsPoints as PointsJax
import kaolin_tpu_torch.experimental.newton as tn
from kaolin_tpu_torch.physics.simplicits import SkinnedPhysicsPoints
from torch_parity import (  # noqa: F401
    jax_unoptimized,
    load_example,
    torch_threads_per_worker,
    warm_torch_exp,
)

Q_UP_Y = (-np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4))

pytestmark = pytest.mark.usefixtures("jax_unoptimized")


def cube_arrays(num_handles=5, n=4, seed=0):
    """``test_newton_bridge.py``'s ``_cube_points`` as keyword arrays."""
    rng = np.random.RandomState(seed)
    g = np.linspace(-0.25, 0.25, n)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts.astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs), np.ones((len(pts), 1))],
                       1).astype(np.float32)
    dwdx = np.zeros((len(pts), num_handles, 3), np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    return dict(pts=pts, yms=5e4, prs=0.45, rhos=500.0, appx_vol=0.125,
                skinning_weights=w, dwdx=dwdx)


def shape_args(kind, pos, size, mu=0.4, vel=True):
    q = Q_UP_Y if kind == PLANE else (0.0, 0.0, 0.0, 1.0)
    return ((kind,), np.asarray(pos, np.float32)[None],
            np.asarray(q, np.float32)[None],
            np.full((1, 3), 0.1 if vel else 0.0, np.float32),
            np.full((1, 3), 0.05 if vel else 0.0, np.float32),
            np.zeros((1, 3), np.float32), np.asarray(size, np.float32)[None],
            np.asarray([2e3], np.float32), np.asarray([1e3], np.float32),
            np.asarray([mu], np.float32))


def both_shapes(*args):
    return jn.RigidShapes(*args), tn.RigidShapes(*args, device="cpu")


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


KINDS = [(PLANE, (0.0, -0.3, 0.0), (0.0, 0.0, 0.0)),
         (SPHERE, (0.0, -1.0, 0.0), (0.8, 0.0, 0.0)),
         (BOX, (0.0, -1.0, 0.0), (1.0, 0.7, 1.0))]


def detect_points():
    """Random points, points inside the box, a tie of two gaps (x and z
    of the box) at sign 0 and 1, and the sphere's centre."""
    rng = np.random.RandomState(4)
    special = np.asarray([[0.0, -1.0, 0.0], [0.2, -0.9, 0.1],
                          [0.5, -1.2, 0.5], [0.0, -1.0, 0.5],
                          [0.3, -1.0, 0.0], [0.0, -1.65, 0.0],
                          [-0.95, -1.0, 0.95]], np.float32)
    return np.concatenate([rng.uniform(-2, 2, (40, 3)).astype(np.float32),
                           special])


@pytest.mark.parametrize("kind,pos,size", KINDS)
def test_detect_matches_jax(kind, pos, size):
    js, ts = both_shapes(*shape_args(kind, pos, size))
    p = detect_points()
    want = js.detect(jnp.asarray(p))
    got = ts.detect(torch.from_numpy(p))
    for k in ("bx", "normal", "bv"):
        close(got[k], want[k], 1e-6)
    assert ts.num_shapes == 1 and tn.RigidShapes.empty(
        device="cpu").num_shapes == 0


def random_forces(shapes_pair, n=20, lagged=True, mu=0.7, kv=0.0, seed=0):
    """``_random_force`` for both packages from one numpy draw →
    ((jax force, dx, x0), (port force, dx, x0))."""
    rng = np.random.RandomState(seed)
    vols = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    prev = x0 + rng.randn(n, 3).astype(np.float32) * 0.02
    dx = (prev - x0) + rng.randn(n, 3).astype(np.float32) * 0.01
    out = []
    for pkg, shapes, arr in ((jn, shapes_pair[0], jnp.asarray),
                             (tn, shapes_pair[1], torch.from_numpy)):
        force = pkg.ParticleShapeSoftContact(
            shapes, arr(vols), dt=0.02, particle_mu=mu,
            friction_use_lagged_body_contact_force_norm=lagged,
            velocity_penalty_kv_scale=kv, coeff_of_restitution=0.3)
        force = force.with_step_state(arr(prev))
        if lagged:
            force = force.update_lagged_body_contact_force_norm(
                arr(prev) - arr(x0), arr(x0))
        out.append((force, arr(dx), arr(x0)))
    return out


@pytest.mark.parametrize("lagged", [True, False])
@pytest.mark.parametrize("kind,pos,size", KINDS)
def test_energy_gradient_hessian_match_jax(kind, pos, size, lagged):
    (jf, jdx, jx0), (tf, tdx, tx0) = random_forces(
        both_shapes(*shape_args(kind, pos, size)), lagged=lagged, kv=0.5)
    e = float(jf.energy(jdx, jx0, 1.3))
    assert e > 0
    np.testing.assert_allclose(float(tf.energy(tdx, tx0, 1.3)), e,
                               rtol=1e-5)
    close(tf.gradient(tdx, tx0, 1.3), jf.gradient(jdx, jx0, 1.3), 1e-5)
    close(tf.hessian(tdx, tx0, 1.3), jf.hessian(jdx, jx0, 1.3), 1e-5)
    close(tf.lagged_norm, jf.lagged_norm, 1e-6)


@pytest.mark.parametrize("kind,pos,size", KINDS)
def test_gradient_matches_autograd_with_lagged_friction(kind, pos, size):
    """With the lagged norm frozen, the analytic gradient is the exact
    derivative of the energy (the JAX test's tolerance)."""
    _, (force, dx, x0) = random_forces(
        both_shapes(*shape_args(kind, pos, size)), lagged=True, kv=0.5)
    dx = dx.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(force.energy(dx, x0, 1.3), dx)
    np.testing.assert_allclose(force.gradient(dx.detach(), x0, 1.3).numpy(),
                               g_ad.numpy(), rtol=2e-4, atol=2e-4)


def test_hessian_matches_autograd_frictionless():
    args = shape_args(PLANE, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), mu=0.0,
                      vel=False)
    _, (force, dx, x0) = random_forces(both_shapes(*args), lagged=False,
                                       mu=0.0, kv=0.0)
    h_ad = torch.autograd.functional.jacobian(
        lambda d: force.gradient(d, x0, 1.0), dx)
    n = dx.shape[0]
    blocks = h_ad.numpy()[np.arange(n), :, np.arange(n), :]
    np.testing.assert_allclose(force.hessian(dx, x0, 1.0).numpy(), blocks,
                               rtol=1e-4, atol=1e-4)


def test_energy_zero_when_separated():
    args = shape_args(PLANE, (0.0, -10.0, 0.0), (0.0, 0.0, 0.0), mu=0.5,
                      vel=False)
    _, (force, dx, x0) = random_forces(both_shapes(*args))
    assert float(force.energy(dx, x0, 1.0)) == 0.0
    assert float(force.gradient(dx, x0, 1.0).abs().max()) == 0.0
    assert float(force.hessian(dx, x0, 1.0).abs().max()) == 0.0


def build_cube(pkg, add_shapes, timestep=0.01, **contact_kwargs):
    """``_build_cube_model`` in either package (the port's on the CPU)."""
    builder = pkg.SimplicitsModelBuilder(up_axis="y", gravity=-9.8)
    points = (PointsJax if pkg is jn else SkinnedPhysicsPoints)(
        **cube_arrays())
    builder.add_simplicits_object(points)
    add_shapes(builder)
    builder.configure_soft_contact(particle_ke=5e4, particle_mu=0.5,
                                   **contact_kwargs)
    kw = {} if pkg is jn else {"device": "cpu"}
    model = builder.finalize(timestep=timestep, max_newton_steps=5,
                             max_ls_steps=10, conv_tol=1e-9, **kw)
    model.simplicits_scene.force_dict["pt_wise"][
        "newton_soft_collisions"]["coeff"] = 1.0
    return model


def qr_blocks(scene, name):
    """The scene's block-diagonal ``qr_tfm`` or ``qr_tfm_inv``, float64."""
    return scipy.linalg.block_diag(*(
        np.asarray(getattr(o, name), np.float64)
        for o in scene.sim_obj_dict.values()))


def rollouts(add_shapes, steps, lockstep, rounding_steps=()):
    """The port's own rollout of ``steps`` → its states, after holding
    its first ``lockstep`` steps against JAX's: at each the port is given
    JAX's state (z taken across through the pre-QR basis in float64) and
    its B z must lie within 2e-5 of max|B z| of JAX's next one. Only at
    the 0-based ``rounding_steps`` may it lie further, by at most twice
    the port's own spread there: the port's step from z and z_dot changed
    by ±1e-7 and ±2e-7 relative, float32's rounding of the state given.
    At those steps the last Newton iterations move the energy near its
    minimum by about its float32 rounding, so that the line search's
    Armijo test takes or refuses them on rounding: at steps 35 and 39 of
    the plane the port's step lies 2.45e-5 and 2.53e-5 of max|B z| from
    JAX's, and the perturbed steps 2.44e-5 and 2.56e-5 from the port's.
    ``tests/test_torch_collision_scene.py`` bounds contact steps alike."""
    jmodel, tmodel = build_cube(jn, add_shapes), build_cube(tn, add_shapes)
    jsolver, tsolver = jn.SimplicitsSolver(jmodel), tn.SimplicitsSolver(
        tmodel)
    js, ts = jmodel.simplicits_scene, tmodel.simplicits_scene
    conv = qr_blocks(ts, "qr_tfm_inv") @ qr_blocks(js, "qr_tfm")
    rest = np.asarray(js.sim_pts)

    def across(z):
        return torch.from_numpy(
            (conv @ np.asarray(z, np.float64)).astype(np.float32))

    jstate = jmodel.state()
    tshapes = tmodel.state().shapes

    def port_step(z_scale=1.0, zd_scale=1.0):
        given = tn.SimplicitsState(
            across(jstate.sim_z) * z_scale, across(jstate.sim_z_prev),
            across(jstate.sim_z_dot) * zd_scale,
            torch.from_numpy(np.array(jstate.particle_q)),
            torch.from_numpy(np.array(jstate.particle_qd)), tshapes)
        return tsolver.step(given).particle_q.numpy() - rest

    for i in range(lockstep):
        got = port_step()
        previous = jstate
        jstate = jsolver.step(jstate)
        want = np.asarray(jstate.particle_q) - rest
        err = np.abs(got - want).max()
        tol = 2e-5 * np.abs(want).max()
        if err > tol:
            assert i in rounding_steps, (i, err, tol)
            jstate, nxt = previous, jstate
            variants = [port_step(1.0 + d, 1.0 + e)
                        for d, e in ((-2e-7, 0), (-1e-7, 0), (1e-7, 0),
                                     (2e-7, 0), (0, -2e-7), (0, -1e-7),
                                     (0, 1e-7), (0, 2e-7))]
            jstate = nxt
            spread = max(np.abs(v - got).max() for v in variants)
            assert err <= tol + 2 * spread, (i, err, tol, spread)

    model = build_cube(tn, add_shapes)
    solver = tn.SimplicitsSolver(model)
    state = model.state()
    states = []
    for _ in range(steps):
        state = solver.step(state)
        states.append(state)
    return states


def test_cube_drops_onto_rigid_plane_and_rests():
    states = rollouts(lambda b: b.add_ground_plane(height=-0.5), 80, 40,
                      rounding_steps=(35, 39))
    min_y0 = float(cube_arrays()["pts"][:, 1].min())
    heights = [float(s.particle_q[:, 1].min()) for s in states]
    speeds = [float(torch.linalg.vector_norm(s.particle_qd, dim=-1).max())
              for s in states]
    assert np.all(np.isfinite(heights)) and np.all(np.isfinite(speeds))
    assert min(heights) < min_y0 - 0.05, "cube should fall"
    assert heights[-1] > -0.6, f"sank through the plane: {heights[-1]}"
    assert speeds[-1] < 0.5 * max(speeds), "should dissipate kinetic energy"


def test_cube_drops_onto_rigid_sphere():
    states = rollouts(
        lambda b: b.add_shape_sphere((0.05, -1.3, 0.0), radius=0.8), 60, 30)
    q = states[-1].particle_q.numpy()
    assert np.all(np.isfinite(q))
    d_center = np.linalg.norm(q - np.array([0.05, -1.3, 0.0]), axis=-1)
    assert d_center.min() > 0.7, "particles penetrated deep into the sphere"


def test_implicit_step_decreases_incremental_energy():
    """The accepted Newton step does not raise the implicit-integration
    objective (Armijo), measured at the step's fixed contacts."""
    model = build_cube(tn, lambda b: b.add_ground_plane(height=-0.35))
    solver = tn.SimplicitsSolver(model)
    state = model.state()
    scene = model.simplicits_scene
    eye = torch.eye(3)
    for _ in range(5):
        c = solver._prepare(solver._consts, state)
        z0 = state.sim_z

        def objective(z):
            dxv = (c["B"] @ z).reshape(-1, 3)
            F = (c["dFdz"] @ z).reshape(-1, 3, 3) + eye
            pe = sum(obj.energy(dxv, c["pts"], coeff)
                     for obj, coeff in c["pt_forces"])
            pe = pe + sum(obj.energy(F, coeff)
                          for obj, coeff in c["defo_forces"])
            delta = z - z0 - scene.timestep * state.sim_z_dot
            return 0.5 * delta @ (c["BMB"] @ delta) + \
                scene.timestep ** 2 * pe

        e_before = float(objective(z0))
        state = solver.step(state)
        e_after = float(objective(state.sim_z))
        assert np.isfinite(e_after)
        assert e_after <= e_before + 1e-4 * abs(e_before) + 1e-6


def test_friction_slows_sliding():
    """A cube sliding on a frictional plane loses tangential speed faster
    than on a frictionless one."""
    def run(mu):
        model = build_cube(
            tn, lambda b: b.add_ground_plane(height=-0.27, mu=mu),
            friction_use_lagged_body_contact_force_norm=True)
        solver = tn.SimplicitsSolver(model)
        state = model.state()
        scene = model.simplicits_scene
        zd = torch.zeros_like(scene.sim_z)
        zd[-9] = 2.0  # d(t_x)/dt of the constant handle
        qr = scene.sim_qr_tfm_inv_red
        state = state._replace(sim_z_dot=zd if qr is None else qr @ zd)
        for _ in range(40):
            state = solver.step(state)
        return float(state.particle_q[:, 0].mean())

    slide_frictionless = run(0.0)
    slide_friction = run(1.5)
    assert np.isfinite(slide_friction) and np.isfinite(slide_frictionless)
    assert 0.0 < slide_friction < slide_frictionless * 0.75


def test_builder_solver_api_parity_flow():
    builder = tn.SimplicitsModelBuilder(up_axis="y", gravity=-9.8)
    oid = builder.add_simplicits_object(
        SkinnedPhysicsPoints(**cube_arrays()))
    assert oid == 0
    builder.add_ground_plane(height=-1.0)
    model = builder.finalize(device="cpu", timestep=0.02)
    assert model.contact_force is not None
    assert model.simplicits_scene.force_dict["pt_wise"][
        "newton_soft_collisions"]["coeff"] == 0.001
    assert model.simplicits_particle_start == 0
    assert model.simplicits_particle_end == 64
    state = model.state()
    assert state.particle_q.shape == (64, 3)
    solver = tn.SimplicitsSolver(model)
    s1 = solver.step(state, state_out=None, control=None, contacts=None,
                     dt=0.02)
    assert s1.sim_z.shape == state.sim_z.shape
    assert model.simplicits_scene.current_sim_step == 1
    assert torch.equal(model.simplicits_scene.sim_z, s1.sim_z)
    with pytest.raises(ValueError):
        solver.step(s1, dt=0.5)
    # shapes but no object: the settings would be dropped
    empty = tn.SimplicitsModelBuilder()
    empty.add_shape_box((0, 0, 0), (1, 1, 1))
    with pytest.raises(ValueError, match="no simplicits objects"):
        empty.finalize(device="cpu")
    with pytest.raises(RuntimeError):
        tn.SimplicitsModelBuilder().finalize(device="cpu").state()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tn.SimplicitsModel()


def test_requires_grad_step_gradient_matches_jax():
    """``finalize(requires_grad=True)``: the gradient of the particles'
    summed height after one step by the initial velocity in the raw basis,
    against ``jax.grad`` through JAX's step."""
    v_raw = np.zeros(60, np.float32)
    v_raw[-9], v_raw[-7] = 0.5, -1.0

    def setup(pkg):
        builder = pkg.SimplicitsModelBuilder(up_axis="y", gravity=-9.8)
        points = (PointsJax if pkg is jn else SkinnedPhysicsPoints)(
            **cube_arrays())
        builder.add_simplicits_object(points)
        builder.add_ground_plane(height=-0.26)
        builder.configure_soft_contact(particle_ke=5e4, particle_mu=0.5)
        kw = {} if pkg is jn else {"device": "cpu"}
        model = builder.finalize(requires_grad=True, timestep=0.01,
                                 max_newton_steps=3, max_ls_steps=4,
                                 conv_tol=1e-9, **kw)
        model.simplicits_scene.force_dict["pt_wise"][
            "newton_soft_collisions"]["coeff"] = 1.0
        assert model.simplicits_scene.differentiable
        return model, pkg.SimplicitsSolver(model)

    jmodel, jsolver = setup(jn)
    jstate = jmodel.state()
    jqr = jmodel.simplicits_scene.sim_qr_tfm_inv_red

    def jloss(v):
        st = jstate._replace(sim_z_dot=jqr @ v)
        consts = jsolver._prepare(jsolver._consts, st)
        z, _, _ = jsolver._step(consts, st.sim_z, st.sim_z_prev,
                                st.sim_z_dot)
        return jnp.sum(jmodel.sim_z_to_full(z)[:, 1])

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(v_raw)))
    tmodel, tsolver = setup(tn)
    v = torch.from_numpy(v_raw).requires_grad_(True)
    state = tmodel.state()
    state = state._replace(
        sim_z_dot=tmodel.simplicits_scene.sim_qr_tfm_inv_red @ v)
    out = tsolver.step(state)
    out.particle_q[:, 1].sum().backward()
    assert np.abs(want).max() > 0
    close(v.grad.numpy(), want, 1e-4)


def test_example_smoke_body(tmp_path):
    """``examples/torch_newton_coupling.py``'s smoke size on the CPU: 20
    finite steps that fall onto the sphere, a Timelapse written every 10,
    its last checkpoint equal to the state it logged to the digits the
    .usda text keeps."""
    from kaolin_tpu_torch.io.usd import import_pointcloud
    ex = load_example("torch_newton_coupling")
    model, states, logged = ex.run("cpu", 20, out=str(tmp_path),
                                   quiet=True)
    assert logged == [0, 10]
    assert all(bool(torch.isfinite(s.particle_q).all()) for s in states)
    assert float(states[-1].particle_q[:, 1].min()) < \
        float(model.simplicits_scene.sim_pts[:, 1].min()) - 0.05
    pc = import_pointcloud(
        str(tmp_path / "soft_cube" / "pointcloud_0.usda"), time=10,
        device="cpu")
    # the .usda text keeps 6 significant digits, read back in float32
    np.testing.assert_allclose(pc.points.numpy(),
                               states[10].particle_q.numpy(), rtol=5.2e-6,
                               atol=0)
