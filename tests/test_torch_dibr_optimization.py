"""The DIB-R optimisation loop of ``examples/torch_dibr_optimization.py``
against the same loop in JAX, on the CPU.

The JAX loop uses optax's Adam and the JAX package's rasterize with its
binned soft mask holding every face. It does not call dibr_rasterization:
at one face that runs _soft_mask_unbatched, whose gradient drops terms
(ROADMAP, Queue C, F5), and its loss curve drifts from the exact one by
about 1% within 20 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from kaolin_tpu.metrics.render import mask_iou as mask_iou_jax
from kaolin_tpu.render.mesh.dibr import (
    _soft_mask_binned,
    dibr_rasterization as dibr_rasterization_jax,
)
from kaolin_tpu.render.mesh.rasterization import rasterize as rasterize_jax
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401


def _jax_loop(res, iters):
    def triangle(shift):
        return jnp.asarray([[[[-0.4 + shift, -0.4], [0.4 + shift, -0.4],
                              [0.0 + shift, 0.45]]]])

    fvz = jnp.full((1, 1, 3), -1.0)
    feat = jnp.ones((1, 1, 3, 3))
    nz = jnp.ones((1, 1))
    _, target_mask, _ = dibr_rasterization_jax(res, res, fvz, triangle(0.0),
                                               feat, nz)
    target = (target_mask > 0.5).astype(jnp.float32)

    def loss_fn(v):
        _, idx = rasterize_jax(res, res, fvz, v, feat, valid_faces=nz >= 0)
        soft = jax.vmap(lambda a, s: _soft_mask_binned(
            a * 1000.0, s, 70.0, 0.5, 1000.0, res, res, tile_px=32,
            cap=1))(v, idx)
        return mask_iou_jax(soft, target)

    fvi = triangle(0.45)
    opt = optax.adam(2e-2)
    state = opt.init(fvi)
    step = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(iters):
        val, grad = step(fvi)
        updates, state = opt.update(grad, state)
        fvi = optax.apply_updates(fvi, updates)
        losses.append(float(val))
    return np.asarray(losses), np.asarray(fvi)


def test_optimization_loop_matches_jax():
    """20 steps of torch Adam against 20 of optax Adam: per-step loss within
    rtol 1e-3, final vertices within 1e-3."""
    ex = load_example()
    want_losses, want_fvi = _jax_loop(64, 20)
    losses, fvi = ex.optimize("cpu", res=64, iters=20)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < 0.5 * losses[0]
    np.testing.assert_allclose(fvi.numpy(), want_fvi, atol=1e-3)


def test_config2_step_matches_jax_loss():
    """config2_step at a small size (32², a 10 x 16 sphere): its first loss
    equals the JAX package's config-2 loss on the same inputs, its
    gradients are finite and non-zero, and its parameters move."""
    ex = load_example()
    data = ex.config2_inputs(n_lat=10, n_lon=16)
    img, soft, _ = dibr_rasterization_jax(
        32, 32, jnp.asarray(data["face_vertices_z"]),
        jnp.asarray(data["face_vertices_image"]),
        jnp.asarray(data["face_features"]),
        jnp.asarray(data["face_normals_z"]))
    want = float(jnp.sum(img ** 2) + jnp.sum(soft ** 2))

    out = ex.config2_step("cpu", res=32, steps=2, n_lat=10, n_lon=16)
    np.testing.assert_allclose(out["losses"][0], want, rtol=1e-5)
    for g in (out["grad_fvi"], out["grad_feat"]):
        assert torch.isfinite(g).all() and g.abs().max() > 0
    moved = out["fvi"] - torch.from_numpy(data["face_vertices_image"])
    assert moved.abs().max() > 0
