"""The slice as a whole on the CPU: ``examples/torch_spc_raytrace.py``'s
mesh → SPC → raytrace → nglod-style render → loss → gradients, against the
same pipeline built from kaolin_tpu functions and jnp, at level 5, 32²,
8-wide features and a 16-wide hidden layer.

Both packages trace the same numpy rays through the same octree; the
fields' parameters go to the port through ``nglod_params_from_jax``. The
render, the loss and each parameter's gradient agree within 1e-5 of their
largest entry (the trilinear contraction, the scan and the segment sums
add in another order than XLA; the features' gradient sums colliding
corners in another order too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops import spc as spc_jax
from kaolin_tpu.render.spc import raytrace as rt_jax
from kaolin_tpu_torch.utils.interop import nglod_params_from_jax
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

EX = load_example("torch_spc_raytrace")
LEVEL, RES, FEAT, HIDDEN = 5, 32, 8, 16
TOL = 1e-5


def to_jax_layout(params):
    """A port field → the JAX layout of ``nglod_params_from_jax``."""
    lin = [m for m in params["decoder"] if isinstance(m, torch.nn.Linear)]
    return {"features": params["features"].detach().numpy(),
            "decoder": [{"w": m.weight.detach().numpy().T,
                         "b": m.bias.detach().numpy()} for m in lin]}


def jax_render(params, scene, nuggets, rays, boundaries, first):
    """The nglod-style render in jnp with kaolin_tpu's interpolation and
    packed ray ops, in the example's order. ``boundaries`` is traced under
    jit, so JAX's ``sum_reduce`` gives one row a nugget, of which the first
    rows are the packs' (``first``: each pack's ray, numpy)."""
    ridx, pidx, depth = nuggets
    o, d = rays
    t_in, t_out = depth[:, 0], depth[:, 1]
    x = o[ridx] + (0.5 * (t_in + t_out))[:, None] * d[ridx]
    p = pidx
    f = 0.0
    for lod in range(LEVEL, LEVEL - EX.LODS, -1):
        f = f + spc_jax.unbatched_interpolate_trilinear(
            x[:, None], p, scene["ph"], scene["trinkets"],
            params["features"], lod)[:, 0]
        p = scene["parents"][p]
    l1, l2 = params["decoder"]
    out = jnp.maximum(f @ l1["w"] + l1["b"], 0.0) @ l2["w"] + l2["b"]
    tau = jax.nn.softplus(out[:, 0]) * (t_out - t_in)
    color, _ = rt_jax.exponential_integration(
        jax.nn.sigmoid(out[:, 1:4]), tau[:, None], boundaries, exclusive=True)
    return jnp.zeros((o.shape[0], 3)).at[first].set(color[:len(first)])


@pytest.fixture(scope="module")
def setup():
    port = EX.spc_scene(LEVEL, "cpu")
    oj = jnp.asarray(port["octree"].numpy())
    _, pyr, ex = spc_jax.scan_octrees(oj, np.array([len(oj)], np.int32))
    ph = spc_jax.generate_points(oj, pyr, ex)
    dual, pdual = spc_jax.unbatched_make_dual(ph, np.asarray(pyr)[0])
    trinkets, parents = spc_jax.unbatched_make_trinkets(
        ph, np.asarray(pyr)[0], dual, pdual)
    scene_j = {"octree": oj, "exsum": ex, "ph": ph, "pyr": np.asarray(pyr)[0],
               "trinkets": trinkets, "parents": parents}
    n = port["dual"].shape[0]
    teacher = EX.make_params(n, **EX.TEACHER, feature_dim=FEAT, hidden=HIDDEN,
                             device="cpu")
    student = EX.make_params(n, **EX.STUDENT, feature_dim=FEAT,
                             hidden=HIDDEN, device="cpu")
    return port, scene_j, to_jax_layout(teacher), to_jax_layout(student)


def close(port, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(port.detach().numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("view", [5])
def test_render_loss_and_gradients_match_jax(setup, view):
    port, scene_j, teacher_j, student_j = setup
    o, d = (x.numpy() for x in EX.view_rays(view, RES, "cpu"))
    rays_j = (jnp.asarray(o), jnp.asarray(d))
    nug_j = rt_jax.unbatched_raytrace(
        scene_j["octree"], scene_j["ph"], scene_j["pyr"], scene_j["exsum"],
        *rays_j, LEVEL, with_exit=True)
    nuggets = EX.trace(port, (torch.from_numpy(o), torch.from_numpy(d)))
    for p, j in zip(nuggets, nug_j):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert len(nuggets[0]) > 1000

    rays = (torch.from_numpy(o), torch.from_numpy(d))
    teacher = nglod_params_from_jax(teacher_j)
    with torch.no_grad():
        target = EX.nglod_render(port, teacher, rays)
    student = nglod_params_from_jax(student_j)
    opt = EX.student_optimizer(student)
    image = EX.nglod_render(port, student, rays)
    loss = ((image - target) ** 2).mean()
    opt.zero_grad()
    loss.backward()

    b = rt_jax.mark_pack_boundaries(nug_j[0])
    first = np.asarray(nug_j[0])[np.asarray(b)]

    def loss_j(params, target, b):
        img = jax_render(params, scene_j, nug_j, rays_j, b, first)
        return jnp.mean((img - target) ** 2), img

    @jax.jit
    def step_j(teacher, student, b):
        target = jax_render(teacher, scene_j, nug_j, rays_j, b, first)
        return target, jax.value_and_grad(loss_j, has_aux=True)(
            student, target, b)
    target_j, ((lj, img_j), g) = step_j(
        jax.tree.map(jnp.asarray, teacher_j),
        jax.tree.map(jnp.asarray, student_j), b)
    close(target, target_j, "teacher render")
    assert float(target.abs().max()) > 0.05
    close(image, img_j, "student render")
    np.testing.assert_allclose(float(loss), float(lj), rtol=TOL)
    close(student["features"].grad, g["features"], "features")
    lin = [m for m in student["decoder"] if isinstance(m, torch.nn.Linear)]
    for m, gl in zip(lin, g["decoder"]):
        close(m.weight.grad.T, gl["w"], "decoder weight")
        close(m.bias.grad, gl["b"], "decoder bias")


def test_ten_fit_steps_lower_the_loss(setup):
    """Ten fit steps, one view a step, lower each of the first two views'
    loss."""
    port = setup[0]
    views = [EX.view_rays(k, RES, "cpu") for k in range(EX.VIEWS)]
    state = EX.fit_setup(port, views, feature_dim=FEAT, hidden=HIDDEN)

    def view_loss(k):
        with torch.no_grad():
            img = EX.nglod_render(port, state["student"], views[k])
            return float(((img - state["targets"][k]) ** 2).mean())
    before = [view_loss(k) for k in (0, 1)]
    losses = EX.fit(port, views, 10, state)
    after = [view_loss(k) for k in (0, 1)]
    assert np.isfinite(losses).all() and losses[0] == pytest.approx(
        before[0], rel=1e-6)
    assert all(a < 0.9 * b for a, b in zip(after, before)), (before, after)
