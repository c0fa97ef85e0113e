"""kaolin_tpu_torch.math.quat against kaolin_tpu.math.quat, on the CPU.

The same seeded numpy quaternions, matrices, angles and points go to both
packages, in the (x, y, z, w) layout. Values agree within 1e-6 (float32;
the two take norms in other summation orders); the validity checks agree
exactly. Gradients through quat_unit, rot33_from_quat and
quat_from_angle_axis agree within 1e-5 relative (plus 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.math.quat as jq
import kaolin_tpu_torch.math.quat as tq
from tests.torch_parity import warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

ATOL = 1e-6


def _data():
    rng = np.random.RandomState(0)
    q = rng.randn(6, 4).astype(np.float32)
    q[0] = [0.0, 0.0, 0.0, 1.0]
    q[1] = [0.3, -0.2, 0.1, -0.9]        # negative real part
    angle = rng.uniform(-3, 3, (6, 1)).astype(np.float32)
    axis = rng.randn(6, 3).astype(np.float32)
    pts = rng.randn(6, 3).astype(np.float32)
    rot = np.array(jq.rot33_from_quat(jq.quat_unit(jnp.asarray(q))))
    # the four branches of quat_from_rot33: trace > 0 and each diagonal
    # entry dominant
    flips = [np.diag(d).astype(np.float32) for d in
             ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    rot = np.concatenate([rot, np.stack(flips)], 0)
    t = rng.randn(rot.shape[0], 3).astype(np.float32)
    tf = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True), pts],
                        -1).astype(np.float32)
    return {"q": q, "angle": angle, "axis": axis, "pts": pts, "rot": rot,
            "t": t, "tf": tf, "tf2": tf[::-1].copy(),
            "euc": np.array(jq.euclidean_from_rotation_translation(
                jnp.asarray(rot), jnp.asarray(t)))}


DATA = _data()

# name → (argument keys); each function gets the same arrays in both
CASES = {
    "quat_real": ("q",), "quat_imaginary": ("q",), "quat_positive": ("q",),
    "quat_abs": ("q",), "quat_unit": ("q",), "quat_unit_positive": ("q",),
    "quat_conjugate": ("q",), "quat_inverse": ("q",),
    "quat_mul": ("q", "q"), "quat_rotate": ("q", "pts"),
    "quat_from_angle_axis": ("angle", "axis"), "quat_from_rot33": ("rot",),
    "rot33_inverse": ("rot",), "rot33_rotate": ("t", "rot"),
    "rot33_from_quat": ("q",), "rot33_from_angle_axis": ("angle", "axis"),
    "rot44_from_quat": ("q",), "translation_to_mat44": ("t",),
    "scale_to_mat44": ("t",), "angle_axis_from_quat": ("q",),
    "angle_axis_from_rot33": ("rot",),
    "euclidean_from_rotation_translation": ("rot", "t"),
    "euclidean_rotation_matrix": ("euc",),
    "euclidean_translation_vector": ("euc",), "euclidean_inverse": ("euc",),
    "transform_from_rotation_translation": ("q", "pts"),
    "transform_from_euclidean": ("euc",), "transform_rotation": ("tf",),
    "transform_translation": ("tf",), "transform_inverse": ("tf",),
    "transform_mul": ("tf", "tf2"), "transform_apply": ("tf", "pts"),
    "vector_normalize": ("axis",), "pad_mat33_to_mat44": ("rot",),
}


def close(got, want, rtol=0.0):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    args = CASES[name]
    want = getattr(jq, name)(*(jnp.asarray(DATA[k]) for k in args))
    got = getattr(tq, name)(*(torch.from_numpy(DATA[k]) for k in args))
    close(got, want)


def test_identities_and_degrees():
    close(tq.quat_identity((2, 3), device="cpu"), jq.quat_identity((2, 3)))
    close(tq.rot33_identity(4, device="cpu"), jq.rot33_identity(4))
    close(tq.translation_identity(2, device="cpu"),
          jq.translation_identity(2))
    close(tq.euclidean_identity(3, device="cpu"), jq.euclidean_identity(3))
    close(tq.transform_identity(5, device="cpu"), jq.transform_identity(5))
    a, x = DATA["angle"] * 50, DATA["axis"]
    close(tq.quat_from_angle_axis(torch.from_numpy(a), torch.from_numpy(x),
                                  is_degree=True),
          jq.quat_from_angle_axis(jnp.asarray(a), jnp.asarray(x),
                                  is_degree=True))
    assert tq.quat_identity(2, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("make", [
    lambda **kw: tq.quat_identity((2, 3), **kw),
    lambda **kw: tq.rot33_identity(4, **kw),
    lambda **kw: tq.translation_identity(2, **kw),
    lambda **kw: tq.euclidean_identity(3, **kw),
    lambda **kw: tq.transform_identity(5, **kw),
], ids=["quat", "rot33", "translation", "euclidean", "transform"])
def test_identities_default_to_the_card(make):
    """Without ``device`` each constructor makes its tensor on the CUDA
    device, and raises where there is none: it never falls back to the
    CPU unasked."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    assert make(device="cpu").device.type == "cpu"


def test_validity_checks_match_jax():
    rot = DATA["rot"]
    bad = rot.copy()
    bad[0, 0, 0] += 0.1
    for r in (rot, bad):
        assert tq.is_rot33_valid(torch.from_numpy(r)) == \
            jq.is_rot33_valid(jnp.asarray(r))
    euc = DATA["euc"]
    bad = euc.copy()
    bad[1, 3, 0] = 0.5
    for e in (euc, bad):
        assert tq.is_euclidean_valid(torch.from_numpy(e)) == \
            jq.is_euclidean_valid(jnp.asarray(e))
    with pytest.raises(ValueError):
        tq.is_euclidean_valid(torch.from_numpy(bad), throw=True)


def test_pose_gradients_match_jax():
    """The texture fit's pose: the gradient of a loss of
    rot33_from_quat(quat_unit(q)) applied to points, with respect to q and
    the angle of quat_from_angle_axis, within 1e-5 relative of jax.grad's."""
    q, pts = DATA["q"][2], DATA["pts"]

    def loss_j(q):
        r = jq.rot33_from_quat(jq.quat_unit(q))
        return jnp.sum((jnp.asarray(pts) @ r.T) ** 2 * jnp.arange(3.0))

    qt = torch.from_numpy(q).requires_grad_(True)
    r = tq.rot33_from_quat(tq.quat_unit(qt))
    (torch.from_numpy(pts) @ r.T).square().mul(torch.arange(3.0)).sum() \
        .backward()
    close(qt.grad, jax.grad(loss_j)(jnp.asarray(q)), rtol=1e-5)

    a, x = DATA["angle"][:1], DATA["axis"][0]
    at = torch.from_numpy(a).requires_grad_(True)
    tq.quat_from_angle_axis(at, torch.from_numpy(x)).sum().backward()
    close(at.grad, jax.grad(lambda a: jnp.sum(jq.quat_from_angle_axis(
        a, jnp.asarray(x))))(jnp.asarray(a)), rtol=1e-5)
