"""kaolin_tpu_torch's Simplicits training path against kaolin_tpu's, on the
CPU: the losses, 20 steps of ``create_with_mlp`` from JAX's initial weights
and draws, RKPM, the ``sparse_*`` builders and gradients through the
differentiable sim step.

The same numpy inputs go to both packages; the port takes JAX's random draws
(``losses._draw_batch`` patched to hand them out) and JAX's initial MLP
(``training.SimplicitsMLP`` patched to build it from ``mlp_init``'s weights).
Tolerances, each with the worst case measured on the CPU:

- ``loss_ortho`` rtol 1e-5 (measured 8.1e-8);
- ``loss_elastic``, ``compute_losses`` and the 20 training steps' logged
  losses rtol 2e-3 (measured 1.7e-4 for one evaluation, 5.6e-4 at one
  training step's elastic loss, 2.7e-6 for the orthogonality loss): the
  finite differences divide float32 LBS positions by 2·sqrt(1e-7) ≈ 6.3e-4,
  and each package's float32 elastic loss lies 0.7e-3 to 1.1e-3 from the
  same loss in float64, so the two may part by up to about 2e-3;
- the trained weights within 0.01·lr of JAX's (measured 2.4e-4·lr): Adam's
  first steps move every weight by about ±lr whatever its gradient's
  size, so a gradient entry of the other sign would show as a 2·lr gap;
- RKPM: the same float64 numpy code on the same FPS nodes, shape functions
  within 1e-12 and the float32 weights, up to a sign per column, within
  1e-6 (both measured bit for bit);
- the differentiable step's gradient within 5e-4 of its largest entry
  (measured 8.2e-5), compared as the gradient with respect to the raw
  (pre-QR) displacement of a loss of B z, which does not depend on the QR
  basis; Newton's gradient on a quadratic within 1e-5 (measured 4.2e-7).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.physics.common import optimization as opt_jax
from kaolin_tpu.physics.simplicits import losses as losses_jax
from kaolin_tpu.physics.simplicits import network as net_jax
from kaolin_tpu.physics.simplicits import precomputed as pre_jax
from kaolin_tpu.physics.simplicits import rkpm as rkpm_jax
from kaolin_tpu.physics.simplicits import training as training_jax
from kaolin_tpu.physics.simplicits import SimplicitsScene as SceneJax
from kaolin_tpu_torch.physics.common import optimization as opt
from kaolin_tpu_torch.physics.simplicits import (
    PhysicsPoints,
    SimplicitsObject,
    SimplicitsScene,
    losses,
    precomputed as pre,
    rkpm,
    training,
)
from kaolin_tpu_torch.utils.interop import (
    physics_points_from_jax,
    simplicits_mlp_from_jax,
    simplicits_rkpm_from_jax,
)
from tests.torch_parity import load_example, qr_blocks
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

train_ex = load_example("torch_simplicits_train")

LOSS_RTOL = 2e-3
TRAIN_W_TOL = 0.01      # in units of the learning rate
GRAD_TOL = 5e-4


def t(a):
    return torch.from_numpy(np.array(a))


def box_points(n=256, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)


def rel_err(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def mlp_pair(h=4, layers=2, seed=3):
    """JAX's ``mlp_init`` weights as a JAX ``SkinningFn`` and as the port's
    module."""
    params = net_jax.mlp_init(jax.random.PRNGKey(seed), 3, 64, h, layers)
    return net_jax.SkinningFn(params=params), simplicits_mlp_from_jax(params)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draw(key, n, num_samples, batch, h_learned):
    k_idx, k_tfm = jax.random.split(key)
    idx = jax.random.randint(k_idx, (num_samples,), 0, n)
    return idx, 0.1 * jax.random.normal(k_tfm, (batch, h_learned, 3, 4),
                                        dtype=jnp.float32)


def jax_draw(step_key, n, num_samples, batch, h_learned):
    """``losses.compute_losses``'s draw from one step key, jitted as in the
    training step → (indices int64, transforms) as tensors."""
    idx, tfm = _jax_draw(step_key, n, num_samples, batch, h_learned)
    return t(np.asarray(idx).astype(np.int64)), t(np.array(tfm))


# ---- the losses ----------------------------------------------------------

# jitted, the JAX functions compile once (eagerly, each of their operations
# compiles on its first call)
_loss_elastic_jax = jax.jit(losses_jax.loss_elastic,
                            static_argnames=("interp_material",))


def test_loss_ortho_matches_jax():
    w = np.random.RandomState(1).randn(64, 5).astype(np.float32)
    got = losses.loss_ortho(t(w))
    want = losses_jax.loss_ortho(jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("interp", [0.0, 0.5, 1.0])
def test_loss_elastic_matches_jax(interp):
    """The raw model on normalized points, a batch of 4 random transforms;
    with and without the material interpolation."""
    model_j, model = mlp_pair()
    rng = np.random.RandomState(2)
    pts = rng.rand(64, 3).astype(np.float32)
    yms = rng.uniform(5e3, 2e4, 64).astype(np.float32)
    prs = np.full(64, 0.45, np.float32)
    rhos = np.full(64, 500.0, np.float32)
    tfms = (0.1 * rng.randn(4, 3, 3, 4)).astype(np.float32)
    for interp_material in (False, True):
        want = _loss_elastic_jax(
            model_j, jnp.asarray(pts), jnp.asarray(yms), jnp.asarray(prs),
            jnp.asarray(rhos), jnp.asarray(tfms), 2.0, interp,
            interp_material=interp_material)
        with torch.no_grad():
            got = losses.loss_elastic(model, t(pts), t(yms), t(prs), t(rhos),
                                      t(tfms), 2.0, interp,
                                      interp_material=interp_material)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="not supported"):
        losses.loss_elastic(model, t(pts), t(yms), t(prs), t(rhos), t(tfms),
                            2.0, interp, elasticity_type="linear")


def test_compute_losses_given_jax_draws(monkeypatch):
    """JAX's draws from ``PRNGKey(7)`` through the port's evaluation; the
    port's own draw from a generator has JAX's shapes and distributions'
    ranges."""
    model_j, model = mlp_pair()
    pts = box_points(200) + 0.5
    mats = [np.full(200, v, np.float32) for v in (1e4, 0.45, 500.0)]
    key = jax.random.PRNGKey(7)
    args = dict(batch_size=4, appx_vol=1.0, num_samples=64, le_coeff=1e-1,
                lo_coeff=1e6)
    le_j, lo_j = jax.jit(losses_jax.compute_losses, static_argnames=(
        "batch_size", "num_samples"))(
        model_j, jnp.asarray(pts), *map(jnp.asarray, mats), 0.25, key=key,
        **args)
    drawn = jax_draw(key, 200, 64, 4, 3)
    monkeypatch.setattr(losses, "_draw_batch", lambda *a: drawn)
    with torch.no_grad():
        le, lo = losses.compute_losses(model, t(pts), *map(t, mats), 0.25,
                                       key=None, **args)
    np.testing.assert_allclose(float(le), float(le_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(lo), float(lo_j), rtol=LOSS_RTOL)
    monkeypatch.undo()
    idx, tfms = losses._draw_batch(torch.Generator().manual_seed(0), 200,
                                   64, 4, 3)
    assert idx.shape == (64,) and 0 <= int(idx.min()) <= int(idx.max()) < 200
    assert tfms.shape == (4, 3, 3, 4) and tfms.dtype == torch.float32
    with torch.no_grad():
        le, lo = losses.compute_losses(model, t(pts), *map(t, mats), 0.25,
                                       key=torch.Generator().manual_seed(0),
                                       **args)
    assert np.isfinite([float(le), float(lo)]).all()


# ---- create_with_mlp -----------------------------------------------------

def logged(caplog, name):
    """(step, le, lo) of every training log record of logger ``name``."""
    return [r.args for r in caplog.records if r.name == name]


@pytest.mark.parametrize("lr_end", [1e-3, 1e-4])
def test_create_with_mlp_matches_jax(monkeypatch, caplog, lr_end):
    """20 Adam steps at 4 handles, 2 layers, 64 samples, batch 4, from JAX's
    ``mlp_init`` and with JAX's draws: each step's losses and the trained
    weights; once with a learning rate that falls from 1e-3 to 1e-4
    (optax's ``linear_schedule`` at the count before the update)."""
    h, layers, steps, lr = 4, 2, 20, 1e-3
    pts = box_points(256)
    kw = dict(num_handles=h, num_samples=64, model_layers=layers,
              training_batch_size=4, training_num_steps=steps,
              training_lr_start=lr, training_lr_end=lr_end,
              training_log_every=1)
    key = jax.random.PRNGKey(5)
    caplog.set_level(logging.INFO)
    obj_j = training_jax.SimplicitsObject.create_with_mlp(
        training_jax.PhysicsPoints(jnp.asarray(pts), 1e4, 0.45, 500.0, 1.0),
        key=key, **kw)
    # JAX's chain of keys: k_init, then one split a step
    key, k_init = jax.random.split(key)
    draws = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        draws.append(jax_draw(step_key, 256, 64, 4, h - 1))
    params0 = net_jax.mlp_init(k_init, 3, 64, h, layers)
    monkeypatch.setattr(
        training, "SimplicitsMLP",
        lambda *a, bb_min, bb_max, key: simplicits_mlp_from_jax(
            params0, bb_min, bb_max))
    feed = iter(draws)
    monkeypatch.setattr(losses, "_draw_batch", lambda *a: next(feed))
    obj = SimplicitsObject.create_with_mlp(
        PhysicsPoints(pts, 1e4, 0.45, 500.0, 1.0), **kw)
    assert next(feed, None) is None
    want = np.array(logged(caplog, training_jax.logger.name))
    got = np.array(logged(caplog, training.logger.name))
    assert want.shape == got.shape == (steps, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=LOSS_RTOL)
    for layer, p in zip(obj.skinning_mod.layers, obj_j.skinning_mod.params):
        for mine, theirs in ((layer.weight.T, p["w"]), (layer.bias, p["b"])):
            err = np.abs(mine.detach().numpy() - np.asarray(theirs)).max()
            assert err <= TRAIN_W_TOL * lr, err
    np.testing.assert_allclose(obj.skinning_mod.bb_min.numpy(),
                               np.asarray(obj_j.skinning_mod.bb_min))
    w = obj.skinning_mod.compute_skinning_weights(t(pts)).detach().numpy()
    w_j = np.asarray(obj_j.skinning_mod.compute_skinning_weights(
        jnp.asarray(pts)))
    assert np.abs(w - w_j).max() < 1e-3


def test_create_with_mlp_own_generator():
    """The port's own draws: one seed gives one field, another seed
    another; one handle is the rigid object."""
    phys = PhysicsPoints(box_points(128), 1e4, 0.45, 500.0, 1.0)
    kw = dict(num_handles=3, num_samples=32, model_layers=1,
              training_batch_size=2, training_num_steps=5,
              training_log_every=5)
    fields = [SimplicitsObject.create_with_mlp(phys, key=k, **kw)
              .skinning_mod.compute_skinning_weights(phys.pts).detach()
              for k in (1, torch.Generator().manual_seed(1), 2)]
    assert torch.equal(fields[0], fields[1])
    assert not torch.equal(fields[0], fields[2])
    rigid = SimplicitsObject.create_with_mlp(phys, 1, 32, 1)
    assert rigid.skinning_mod(phys.pts).shape == (128, 0)
    with pytest.raises(ValueError, match="num_handles"):
        SimplicitsObject.create_with_mlp(phys, 0, 32, 1)


def test_linear_schedule_is_optax():
    import optax

    sched = optax.linear_schedule(1e-3, 2e-4, 7)
    for i in range(10):
        np.testing.assert_allclose(training._linear_schedule(1e-3, 2e-4, 7, i),
                                   float(sched(i)), rtol=1e-6)


# ---- RKPM ----------------------------------------------------------------

def test_rkpm_phi_and_grad_phi_match_jax():
    rng = np.random.RandomState(0)
    nodes, radius = rng.rand(20, 3), np.full(20, 0.4)
    x = rng.rand(50, 3) * 0.8 + 0.1
    kj, k = rkpm_jax.RKPM(20), rkpm.RKPM(20)
    kj.set_kernels(nodes, radius)
    k.set_kernels(t(nodes), radius)
    np.testing.assert_allclose(k.phi(t(x)), kj.phi(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(k.grad_phi(x), kj.grad_phi(x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(k.phi(x).sum(1), 1.0, atol=1e-8)


def test_create_with_rkpm_matches_jax_and_simulates():
    """300 points, 5 handles, 24 nodes (``tests/physics/test_rkpm.py``):
    the FPS nodes, the radii, and the weights and their gradients up to a
    sign per column; then 5 steps of the port's scene, finite, falling."""
    pts = (np.random.RandomState(0).rand(300, 3) - 0.5).astype(np.float32)
    phys_j = training_jax.PhysicsPoints(jnp.asarray(pts), 1e4, 0.45, 500.0,
                                        1.0)
    obj_j = training_jax.SimplicitsObject.create_with_rkpm(phys_j, 5, 24)
    phys = physics_points_from_jax(phys_j)
    obj = SimplicitsObject.create_with_rkpm(phys, 5, 24)
    skin, skin_j = obj.skinning_mod, obj_j.skinning_mod
    np.testing.assert_array_equal(skin.rkpm.nodes, skin_j.rkpm.nodes)
    np.testing.assert_array_equal(skin.rkpm.radius, skin_j.rkpm.radius)
    w = skin.compute_skinning_weights(phys.pts)
    dw = skin.compute_dwdx(phys.pts)
    assert w.dtype == torch.float32 and w.shape == (300, 5)
    w_j = np.asarray(skin_j.compute_skinning_weights(jnp.asarray(pts)))
    dw_j = np.asarray(skin_j.compute_dwdx(jnp.asarray(pts)))
    sign = np.sign((w.numpy() * w_j).sum(0))
    np.testing.assert_allclose(w.numpy() * sign, w_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dw.numpy() * sign[:, None], dw_j, rtol=0,
                               atol=1e-6 * np.abs(dw_j).max())
    np.testing.assert_allclose(skin(t(pts) + 0.5).numpy() * sign[:-1],
                               np.asarray(skin_j(jnp.asarray(pts) + 0.5)),
                               atol=1e-6)
    # the JAX field carried across gives the port's numbers
    carried = simplicits_rkpm_from_jax(skin_j)
    np.testing.assert_array_equal(
        carried.compute_skinning_weights(phys.pts).numpy(), w_j)
    scene = SimplicitsScene(timestep=0.03, max_newton_steps=3,
                            max_ls_steps=5, device="cpu")
    oid = scene.add_object(obj, num_qp=300)
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0)
    scene.run_sim_steps(5)
    p = scene.get_object_deformed_pts(oid)
    assert bool(torch.isfinite(p).all()) and float(p[:, 1].mean()) < 0.0


# ---- the sparse builders -------------------------------------------------

def test_sparse_builders_match_jax():
    rng = np.random.RandomState(4)
    n, h = 12, 3
    x0 = rng.rand(n, 3).astype(np.float32)
    w = rng.randn(n, h).astype(np.float32)
    dwdx = rng.randn(n, h, 3).astype(np.float32)
    rhos = rng.uniform(100, 1000, n).astype(np.float32)
    freqs = rng.randn(3, h - 1).astype(np.float32)
    idx = np.array([0, 3, 3, 7, 11])
    static = np.array([False, True, False, False, True])
    cases = [
        (pre.sparse_lbs_matrix(t(w), t(x0)),
         pre_jax.sparse_lbs_matrix(jnp.asarray(w), jnp.asarray(x0))),
        (pre.sparse_dFdz_matrix(t(w), t(dwdx), t(x0)),
         pre_jax.sparse_dFdz_matrix(jnp.asarray(w), jnp.asarray(dwdx),
                                    jnp.asarray(x0))),
        (pre.sparse_dFdz_matrix_from_dense(
            lambda x: torch.cat([torch.sin(x @ t(freqs)),
                                 x.new_ones((x.shape[0], 1))], 1), t(x0)),
         jax.jit(lambda x: pre_jax.sparse_dFdz_matrix_from_dense(
             lambda y: jnp.concatenate([jnp.sin(y @ freqs),
                                        jnp.ones((y.shape[0], 1))], 1),
             x))(jnp.asarray(x0))),
        (pre.sparse_mass_matrix(t(rhos)),
         pre_jax.sparse_mass_matrix(jnp.asarray(rhos))),
        (pre.sparse_collision_jacobian_matrix(t(w), t(x0), t(idx)),
         pre_jax.sparse_collision_jacobian_matrix(
             jnp.asarray(w), jnp.asarray(x0), jnp.asarray(idx))),
        (pre.sparse_collision_jacobian_matrix(t(w), t(x0), t(idx),
                                              t(static)),
         pre_jax.sparse_collision_jacobian_matrix(
             jnp.asarray(w), jnp.asarray(x0), jnp.asarray(idx),
             jnp.asarray(static))),
    ]
    for got, want in cases:
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert not cases[-1][0][3:6].any() and cases[-1][0][:3].any()


# ---- gradients through the step ------------------------------------------

def test_newtons_method_gradient_matches_jax():
    """``newtons_method(differentiable=True)`` on the quadratic of
    ``tests/physics/test_optimization.py``: d sum(x*²)/db by autograd
    against ``jax.grad``."""
    rng = np.random.RandomState(0)
    a_half = rng.randn(6, 6).astype(np.float32)
    a = a_half @ a_half.T + 6 * np.eye(6, dtype=np.float32)
    b0 = rng.randn(6).astype(np.float32)

    def solve_j(b):
        aj = jnp.asarray(a)
        return opt_jax.newtons_method(
            jnp.zeros(6), lambda x: 0.5 * (x - b) @ aj @ (x - b),
            lambda x: aj @ (x - b), lambda x: aj, nm_max_iters=4,
            differentiable=True)

    want = jax.jit(jax.grad(lambda b: jnp.sum(solve_j(b) ** 2)))(
        jnp.asarray(b0))
    b = t(b0).requires_grad_(True)
    at = t(a)
    x = opt.newtons_method(torch.zeros(6), lambda x: 0.5 * (x - b) @ at
                           @ (x - b), lambda x: at @ (x - b), lambda x: at,
                           nm_max_iters=4, differentiable=True)
    torch.sum(x ** 2).backward()
    assert rel_err(b.grad, want) <= 1e-5
    assert float(b.grad.abs().max()) > 0


def test_differentiable_step_gradient_matches_jax():
    """``tests/physics/test_optimization.py``'s 40-point scene (3 Newton,
    6 line-search steps, gravity): the gradient of
    sum((B z_new)²) + sum((B ż_new)²) with respect to z and ż, from a
    seeded state, by autograd against ``jax.grad``, both taken to the raw
    displacement (dL/dq = K⁻ᵀ dL/dz for z = K⁻¹ q)."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(-0.4, 0.4, (40, 3)).astype(np.float32)
    freqs = rng.randn(3, 4).astype(np.float32)
    kw = dict(timestep=0.02, max_newton_steps=3, max_ls_steps=6,
              differentiable=True)
    js = SceneJax(**kw)
    js.add_object(training_jax.SimplicitsObject.create_from_function(
        training_jax.PhysicsPoints(jnp.asarray(pts), 1e4, 0.45, 500.0, 0.5),
        lambda x: jnp.sin(x @ freqs)), num_qp=40)
    js.set_scene_gravity(jnp.asarray([0.0, 9.8, 0.0]))
    ps = SimplicitsScene(device="cpu", **kw)
    ps.add_object(SimplicitsObject.create_from_function(
        PhysicsPoints(pts, 1e4, 0.45, 500.0, 0.5),
        lambda x: torch.sin(x @ t(freqs))), num_qp=40)
    ps.set_scene_gravity((0.0, 9.8, 0.0))
    k_inv = {s: qr_blocks(s, "qr_tfm_inv") for s in (js, ps)}
    q = 0.02 * np.random.RandomState(5).randn(k_inv[js].shape[0])
    qd = 0.2 * np.random.RandomState(6).randn(k_inv[js].shape[0])

    def state(s):
        return [(k_inv[s] @ v).astype(np.float32) for v in (q, qd)]

    step_j, c_j = js.build_functional_step()

    def loss_j(z, zd):
        zn, _, zdn = step_j(c_j, z, z, zd)
        return jnp.sum((c_j["B"] @ zn) ** 2) + jnp.sum((c_j["B"] @ zdn) ** 2)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        *map(jnp.asarray, state(js)))
    step, c = ps.build_functional_step()
    z, zd = (t(v).requires_grad_(True) for v in state(ps))
    z_prev = z.detach().clone().requires_grad_(True)
    zn, _, zdn = step(c, z, z_prev, zd)
    loss = torch.sum((c["B"] @ zn) ** 2) + torch.sum((c["B"] @ zdn) ** 2)
    loss.backward()
    for g, g_j in ((z.grad, want[0]), (zd.grad, want[1])):
        gq = k_inv[ps].T @ g.numpy().astype(np.float64)
        gq_j = k_inv[js].T @ np.asarray(g_j, np.float64)
        assert np.isfinite(gq).all() and np.abs(gq).max() > 0
        assert rel_err(gq, gq_j) <= GRAD_TOL
    assert z_prev.grad is None           # the step does not read z_prev


def test_differentiable_scene_refuses_cuda_graphs():
    with pytest.raises(ValueError, match="no_grad"):
        SimplicitsScene(device="cpu", use_cuda_graphs=True,
                        differentiable=True)


# ---- the example ---------------------------------------------------------

def test_example_builders():
    """The example's path at 8 x 4 segments: the interior sample, 50
    training steps at 5 handles, and 5 sim steps of the baked object."""
    verts, faces = train_ex.torus_mesh((8, 4), device="cpu")
    assert tuple(faces.shape) == (64, 3) and tuple(verts.shape) == (32, 3)
    # closed: every edge is shared by exactly two faces
    edges = torch.sort(faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)[0]
    assert (torch.unique(edges, dim=0, return_counts=True)[1] == 2).all()
    pts, share, box = train_ex.interior_points(verts, faces, 4000, seed=1)
    assert pts.shape[0] == round(share * 4000) and 0.3 < share < 0.6
    obj = train_ex.trained_object(pts, 50, seed=1, num_handles=5, layers=2,
                                  num_samples=200, batch=4, log_every=10)
    w = obj.skinning_mod.compute_skinning_weights(pts)
    assert w.shape == (pts.shape[0], 5) and bool(torch.isfinite(w).all())
    scene = train_ex.trained_scene(obj, num_qps=300)
    h0 = train_ex.mean_height(scene)
    scene.run_sim_steps(5)
    assert bool(torch.isfinite(scene.sim_z).all())
    assert train_ex.mean_height(scene) < h0
