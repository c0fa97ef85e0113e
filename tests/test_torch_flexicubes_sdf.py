"""The slice as a whole on the CPU: ``examples/torch_flexicubes_sdf.py``'s
two forms and ``examples/torch_tutorial_dmtet.py`` against the same loops
in kaolin_tpu with optax, at res 12 for 5 steps (DMTet at its smoke size).

- The bench form: ``bench.py``'s ``bench_flexicubes`` loss through
  ``dense_extract``, the JAX step jitted as the bench jits it.
- The topology form: ``examples/flexicubes_sdf.py``'s loop, the topology
  refreshed every step (host numpy in JAX, torch here), the geometry
  jitted a step in JAX.
- DMTet: the JAX tutorial's MLP from ``PRNGKey(0)`` carried across by
  ``dmtet_mlp_from_jax``.

Two runs of each loop:

- free: the example's own step from the same start as JAX's run; the
  integers (surface cubes, quads, dual vertices, quads' vertex ids) equal
  at every step, the losses finite and falling;
- in lock step: each port step starts from JAX's field (or weights), and
  its Adam is fed JAX's gradient; every step's gradient within 1e-5 of its
  largest entry, and the field (or weights) after the step within 1e-5
  relative.

The free runs are compared by their integers alone: where a gradient is a
sum that cancels, one package gives 0 and the other a rounding residue
(-2^-31 at one cube at step 1 of the bench form), Adam's m̂/(√v̂ + 1e-8)
turns that residue into a step of 0.045·lr, and the two fields part by
9e-4 there from then on. The DMTet MLP's gradient is held as one vector.
The fitted field's marching cubes equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kaolin_tpu.ops.conversions as conv_jax
from kaolin_tpu.ops.conversions import FlexiCubes as JaxFlexiCubes
from kaolin_tpu_torch.utils.interop import dmtet_mlp_from_jax
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

RES, STEPS, REL = 12, 5, 1e-5
FX = load_example("torch_flexicubes_sdf")
DM = load_example("torch_tutorial_dmtet")
DM_JAX = load_example("tutorial_dmtet")


def grad_close(port_grad, want_grad, tol=REL):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(port_grad.detach().numpy(), want_grad, rtol=0,
                               atol=tol * np.abs(want_grad).max())


def set_params(state, values):
    """Put JAX's values into the port's parameters (its Adam state
    stays)."""
    params = [p for g in state["optimizer"].param_groups for p in g["params"]]
    with torch.no_grad():
        for p, x in zip(params, values):
            p.copy_(torch.from_numpy(np.array(x, np.float32)).reshape(
                p.shape))


def step_with(state, loss, grads):
    """The port's Adam step on its parameters with JAX's ``grads`` → the
    port's own gradients (taken before)."""
    opt = state["optimizer"]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for group in opt.param_groups for p in group["params"]]
    own = [p.grad.clone() for p in params]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(np.array(g, np.float32)).reshape(p.shape)
    opt.step()
    return own


def rel_close(port, want, rel=REL):
    port = torch.as_tensor(port).detach().double().numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(port, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_grid():
    fc = JaxFlexiCubes()
    v, c = fc.construct_voxel_grid(RES)
    sdf0 = jnp.linalg.norm(v * jnp.asarray([1.6, 0.7, 1.0]), axis=-1) - 0.35
    return fc, v, c, np.array(sdf0)


def jax_bench_loss(sdf):
    """``bench.py``'s ``bench_flexicubes`` loss, as written there."""
    _, _, reg, aux = conv_jax.dense_extract(sdf, RES, training=True)
    vd, vm = aux["vd_dense"], aux["vd_valid_dense"]
    d = jnp.abs(jnp.sqrt(jnp.sum(vd * vd, axis=1)) - 0.35) * vm
    nv = jnp.clip(jnp.sum(vm), 1, None)
    return jnp.sum(d) / nv + 0.01 * jnp.sum(reg) / nv


def test_start_field_and_grid(jax_grid):
    fc, v, c, sdf0 = jax_grid
    state = FX.setup(RES, "cpu")
    np.testing.assert_array_equal(state["grid_verts"].numpy(), np.asarray(v))
    np.testing.assert_array_equal(state["cube_idx"].numpy(), np.asarray(c))
    rel_close(state["sdf"], sdf0, rel=1e-7)


def test_bench_form_matches_optax(jax_grid):
    _, _, _, sdf0 = jax_grid
    opt = optax.adam(FX.LR)

    @jax.jit
    def one_iter(sdf, opt_state):
        val, g = jax.value_and_grad(jax_bench_loss)(sdf)
        updates, opt_state = opt.update(g, opt_state)
        counts = conv_jax.dense_extract(sdf, RES, training=True)[3]["counts"]
        return optax.apply_updates(sdf, updates), opt_state, val, g, counts

    sdf, opt_state = jnp.asarray(sdf0), opt.init(jnp.asarray(sdf0))
    free = FX.setup(RES, "cpu", sdf=torch.from_numpy(sdf0))
    lock = FX.setup(RES, "cpu", sdf=torch.from_numpy(sdf0))
    free_losses = []
    for _ in range(STEPS):
        set_params(lock, [sdf])
        sdf, opt_state, val, g, counts = one_iter(sdf, opt_state)
        loss, got_counts = FX.bench_step(free)
        free_losses.append(float(loss))
        for k in ("surf_cubes", "quads"):
            assert int(got_counts[k]) == int(counts[k])
        loss, _ = FX.bench_loss(lock["sdf"], RES)
        rel_close(loss, val)
        grad_close(step_with(lock, loss, [g])[0], g)
        rel_close(lock["sdf"], sdf)
    assert np.isfinite(free_losses).all() and free_losses[-1] < free_losses[0]


def test_topology_form_matches_optax(jax_grid):
    fc, v, c, sdf0 = jax_grid
    opt = optax.adam(FX.LR)

    def loss_fn(sdf, topology):
        verts, _, reg = fc(v, sdf, c, RES, topology=topology,
                           training=True)[:3]
        d = jnp.abs(jnp.linalg.norm(verts, axis=-1) - 0.35)
        return jnp.mean(d) + 0.01 * jnp.mean(reg)

    sdf, opt_state = jnp.asarray(sdf0), opt.init(jnp.asarray(sdf0))
    free = FX.setup(RES, "cpu", sdf=torch.from_numpy(sdf0))
    lock = FX.setup(RES, "cpu", sdf=torch.from_numpy(sdf0))
    free_losses = []
    for _ in range(STEPS):
        set_params(lock, [sdf])
        topology = fc.precompute_topology(np.asarray(sdf), c, RES)
        val, g = jax.jit(jax.value_and_grad(
            lambda s: loss_fn(s, topology)))(sdf)
        updates, opt_state = opt.update(g, opt_state)
        sdf = optax.apply_updates(sdf, updates)
        loss, got = FX.topology_step(free)
        free_losses.append(float(loss))
        assert got.total_num_vd == topology.total_num_vd
        np.testing.assert_array_equal(got.quad_vd_idx.numpy(),
                                      topology.quad_vd_idx)
        topo = lock["fc"].precompute_topology(lock["sdf"], lock["cube_idx"],
                                              RES)
        np.testing.assert_array_equal(topo.quad_vd_idx.numpy(),
                                      topology.quad_vd_idx)
        loss = FX.topology_loss(lock, topo)[0]
        rel_close(loss, val)
        grad_close(step_with(lock, loss, [g])[0], g)
        rel_close(lock["sdf"], sdf)
    assert np.isfinite(free_losses).all() and free_losses[-1] < free_losses[0]
    # the fitted field's marching cubes, −sdf at iso 0, equals JAX's
    r = RES + 1
    mv, mf = FX.marching_cubes(free)
    jv, jf = conv_jax.voxelgrids_to_trianglemeshes(
        -np.asarray(free["sdf"].detach()).reshape(1, r, r, r), 0.0)
    assert mf.shape[0] > 0
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv[0]))
    np.testing.assert_array_equal(mf.numpy(), np.asarray(jf[0]))


def jax_dmtet_params():
    """The JAX tutorial's ``init_mlp(PRNGKey(0))``."""
    key, params, widths = jax.random.PRNGKey(0), [], DM.WIDTHS
    for i in range(len(widths) - 1):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (widths[i], widths[i + 1])) \
            * np.sqrt(2.0 / widths[i])
        params.append((w, jnp.zeros(widths[i + 1])))
    return params


def test_dmtet_matches_optax():
    """The tutorial at its smoke size, step by step: the chamfer before
    each step and the weights after it."""
    res, size = DM.SMOKE["res"], DM.SMOKE
    grid_v, tets = DM_JAX.make_tet_grid(res)
    got_grid, got_tets = DM.make_tet_grid(res)
    np.testing.assert_array_equal(got_grid, grid_v)
    np.testing.assert_array_equal(got_tets, tets)
    tgt = jnp.asarray(DM_JAX.target_points(size["targets"],
                                           np.random.RandomState(0)))
    gv = jnp.asarray(grid_v)

    def mlp(params, x):
        h = x
        for w, b in params[:-1]:
            h = jax.nn.relu(h @ w + b)
        w, b = params[-1]
        out = h @ w + b
        sdf = out[:, 0] + (jnp.linalg.norm(x, axis=-1) - 0.7)
        return sdf, jnp.tanh(out[:, 1:]) * (1.0 / res)

    def loss_fn(params):
        sdf, offset = mlp(params, gv)
        out = conv_jax.marching_tetrahedra_fixed(gv + offset, tets, sdf)
        return DM_JAX.masked_chamfer(out["verts"], out["vert_mask"], tgt)

    opt = optax.adam(DM.LR)

    @jax.jit
    def step(params, state):
        val, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, val

    params = jax_dmtet_params()
    opt_state = opt.init(params)

    def port_state():
        return DM.setup("cpu", smoke=True, mlp=dmtet_mlp_from_jax(
            [(np.asarray(w), np.asarray(b)) for w, b in params]))

    free, lock = port_state(), port_state()
    rel_close(free["target"], tgt, rel=0)
    free_losses = []
    grad_fn = jax.jit(jax.grad(loss_fn))
    for _ in range(size["steps"]):
        set_params(lock, [x for w, b in params for x in (np.asarray(w).T, b)])
        grads = grad_fn(params)
        params, opt_state, val = step(params, opt_state)
        free_losses.append(float(DM.step(free)))
        out = DM.extract(lock)
        loss = DM.masked_chamfer(out["verts"], out["vert_mask"],
                                 lock["target"])
        rel_close(loss, val)
        # torch's parameters: (w.T, b) a layer; JAX's: (w, b); the MLP's
        # gradient is one vector
        want = [x for w, b in grads for x in (np.asarray(w).T, b)]
        own = step_with(lock, loss, want)
        grad_close(torch.cat([g.reshape(-1) for g in own]),
                   np.concatenate([np.asarray(g).reshape(-1) for g in want]))
        linears = [m for m in lock["mlp"] if isinstance(m, torch.nn.Linear)]
        for m, (w, b) in zip(linears, params):
            rel_close(m.weight.T, w)
            rel_close(m.bias, b)
    assert np.isfinite(free_losses).all() and free_losses[-1] < free_losses[0]
    out = DM.main("cpu", smoke=True, mlp=dmtet_mlp_from_jax(
        [(np.asarray(w), np.asarray(b)) for w, b in jax_dmtet_params()]))
    assert np.isfinite(out["losses"]).all() and out["faces"] > 0


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FX.setup(RES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DM.setup(smoke=True)
