"""The DIB-R pose-and-texture fit of ``examples/torch_dibr_texture_fit.py``
against the same fit written with kaolin_tpu, on the CPU.

At a small size (a 10 x 16 UV sphere, 288 faces; a 3 x 32 x 32 texture;
64², B = 2) the same numpy inputs go through both: the target views, then
5 Adam steps (torch.optim.Adam against optax.adam, lr 1e-2) over texture,
vertex offsets, quaternion, translation and log-scale. The losses agree
within rtol 1e-3 at every step and the parameters after 5 steps within
1e-3 (a tenth of a learning rate), as
``tests/test_torch_dibr_optimization.py`` holds its loop.

The JAX fit does not call ``dibr_rasterization``: below 1024 faces that
takes the all-faces soft mask whose gradient drops terms (ROADMAP, Queue C,
F5). It calls ``rasterize`` and ``_soft_mask_binned`` with a capacity of
every face, so no JAX tile drops one; the port has no capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import kaolin_tpu.math.quat as jq
from kaolin_tpu.metrics.render import mask_iou as mask_iou_jax
from kaolin_tpu.ops.mesh import uniform_laplacian as uniform_laplacian_jax
from kaolin_tpu.render.camera import legacy as jleg
from kaolin_tpu.render.mesh import utils as jutils
from kaolin_tpu.render.mesh.dibr import _soft_mask_binned
from kaolin_tpu.render.mesh.rasterization import rasterize as rasterize_jax
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

RES, STEPS = 64, 5
SMALL = dict(n_lat=10, n_lon=16, tex=32)


def _jax_fit(inp, res, steps):
    """The example's fit in JAX → (losses per step, parameters)."""
    faces = inp["faces"]
    f = faces.shape[0]
    template = jnp.asarray(inp["template"])
    uvs = jnp.asarray(inp["face_uvs"])[None]
    cams = jleg.generate_transformation_matrix(
        jnp.asarray(inp["cam_pos"]), jnp.asarray(inp["look_at"]),
        jnp.asarray(inp["up"]))
    proj = jleg.generate_perspective_projection(float(inp["fovy"]))
    lap = uniform_laplacian_jax(template.shape[0], faces)
    target_q = jq.quat_from_angle_axis(jnp.asarray(inp["target_angle"]),
                                       jnp.asarray(inp["target_axis"]))

    def posed(p):
        rot = jq.rot33_from_quat(jq.quat_unit(p["q"]))
        return (jnp.exp(p["s"]) * (template + p["offsets"])) @ rot.T + p["t"]

    def render(p, views):
        b = views.shape[0]
        fvc, fvi, n = jutils.prepare_vertices(
            posed(p)[None], faces, proj, camera_transform=cams[views])
        fuv = jnp.broadcast_to(uvs, (b,) + uvs.shape[1:])
        (uv_img, mask), idx = rasterize_jax(
            res, res, fvc[..., 2], fvi, [fuv, jnp.ones_like(fuv[..., :1])],
            valid_faces=n[..., 2] >= 0.0)
        soft = jax.vmap(lambda a, s: _soft_mask_binned(
            a * 1000.0, s, 7000.0, 0.02, 1000.0, res, res, tile_px=32,
            cap=f))(fvi, idx)
        tex = jnp.broadcast_to(p["texture"][None], (b,) + p["texture"].shape)
        img = jutils.texture_mapping(uv_img, tex, mode="bilinear") * mask
        return img, soft, mask[..., 0]

    target = {"texture": jnp.asarray(inp["target_texture"]),
              "offsets": jnp.asarray(inp["target_shape"]) - template,
              "q": target_q, "t": jnp.asarray(inp["target_t"]),
              "s": jnp.zeros(1)}
    t_img, _, t_mask = jax.jit(render)(target, jnp.arange(8))

    def loss_fn(p, views):
        img, soft, _ = render(p, views)
        l_img = jnp.mean(jnp.abs(img - t_img[views]))
        l_sil = mask_iou_jax(soft, t_mask[views])
        lv = lap @ posed(p)
        return l_img + l_sil + 0.03 * jnp.mean(jnp.sum(lv * lv, axis=-1))

    tex = inp["target_texture"].shape[-1]
    params = {"texture": jnp.full((3, tex, tex), 0.5),
              "offsets": jnp.zeros_like(template),
              "q": jnp.asarray([0.0, 0.0, 0.0, 1.0]), "t": jnp.zeros(3),
              "s": jnp.zeros(1)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    step = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for i in range(steps):
        views = jnp.asarray([(2 * i) % 8, (2 * i + 1) % 8])
        val, grad = step(params, views)
        updates, state = opt.update(grad, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(val))
    return np.asarray(losses), {k: np.asarray(v) for k, v in params.items()}


def test_texture_fit_matches_jax():
    ex = load_example("torch_dibr_texture_fit")
    inp = ex.texfit_inputs(**SMALL)
    want_losses, want = _jax_fit(inp, RES, STEPS)
    scene = ex.texfit_setup(inp, "cpu", RES)
    params = ex.initial_params(scene)
    opt = ex.make_optimizer(params)
    losses = [float(ex.texfit_step(scene, params, opt, i)[0])
              for i in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < losses[0]
    for k in ex.PARAMS:
        np.testing.assert_allclose(params[k].detach().numpy(), want[k],
                                   atol=1e-3, err_msg=k)


def test_texture_fit_inputs_are_config_2():
    """The full-size inputs: the 40 x 64 sphere (2,560 vertices, 4,992
    faces), per-face UVs with the seam at u = 1 and the first and last
    rings at v = 0 and 1, a 3 x 256 x 256 texture in [0, 1], 8 cameras at
    distance 3 and elevation 20°; and the step's views."""
    ex = load_example("torch_dibr_texture_fit")
    inp = ex.texfit_inputs()
    assert inp["template"].shape == (2560, 3)
    assert inp["faces"].shape == (4992, 3)
    uv = inp["face_uvs"]
    assert uv.shape == (4992, 3, 2) and uv.min() == 0.0 and uv.max() == 1.0
    assert (uv[:, :, 0] == 1.0).sum() == 39 * 3
    assert (uv[:, :, 1] == 0.0).sum() == 64 * 3
    assert (uv[:, :, 1] == 1.0).sum() == 64 * 3
    tex = inp["target_texture"]
    assert tex.shape == (3, 256, 256) and 0 <= tex.min() < tex.max() <= 1
    pos = inp["cam_pos"]
    np.testing.assert_allclose(np.linalg.norm(pos, axis=1), 3.0, rtol=1e-6)
    np.testing.assert_allclose(np.degrees(np.arcsin(pos[:, 1] / 3.0)), 20.0,
                               rtol=1e-5)
    assert [ex.step_views(s) for s in (0, 3, 4)] == [[0, 1], [6, 7], [0, 1]]
