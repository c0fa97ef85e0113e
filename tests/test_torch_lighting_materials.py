"""The port's SG/SH lighting (``kaolin_tpu_torch/render/lighting``) and PBR
materials (``render/materials.py``) against kaolin_tpu's, on the CPU.

Every exported lighting function on ``tests/render/test_lighting.py``'s
``data`` inputs within 1e-5 relative (and 1e-6 of the largest entry where
a value is near 0); the gradients of ``sg_warp_specular_term`` and
``sg_diffuse_inner_product`` in all their inputs within 1e-5 of max|g|,
with points on the clip bounds (a view along the normal, a grazing view, a
light channel of amplitude 0); ``from_environment_map`` within 1e-5 of the
largest radiance it gives on the map (its amplitudes within 1e-5, or no
farther from a float64 solve than JAX's where the normal equations scale
rounding past that). The materials' attributes, converters and random
helpers as JAX's.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.render.lighting as jl
import kaolin_tpu.render.materials as jmat
import kaolin_tpu_torch.render.lighting as tl
import kaolin_tpu_torch.render.materials as tmat
from kaolin_tpu_torch.render.easy_render import (
    default_camera,
    default_lighting,
    default_material,
)
from kaolin_tpu_torch.utils import pbr_material_from_jax, sg_lighting_from_jax
from tests.torch_parity import jax_unoptimized  # noqa: F401
from tests.torch_parity import warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_unoptimized")
RTOL, GRAD_TOL = 1e-5, 1e-5


def lighting_data():
    """``tests/render/test_lighting.py``'s ``data`` fixture, as numpy."""
    rng = np.random.RandomState(0)
    num_sg = 4
    n = 32
    amplitude = np.abs(rng.rand(num_sg, 3).astype(np.float32)) * 3
    direction = rng.randn(num_sg, 3).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    sharpness = (rng.rand(num_sg).astype(np.float32) * 8 + 1)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    albedo = rng.rand(n, 3).astype(np.float32)
    roughness = rng.rand(n).astype(np.float32) * 0.8 + 0.1
    view = rng.randn(n, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    return dict(amplitude=amplitude, direction=direction,
                sharpness=sharpness, normals=normals, albedo=albedo,
                roughness=roughness, view=view)


D = lighting_data()
OTHER = dict(amplitude=D["amplitude"][::-1].copy(),
             direction=D["direction"][::-1].copy(),
             sharpness=D["sharpness"][::-1].copy())
LIGHT = ("amplitude", "direction", "sharpness")
# function → its inputs by name in D (OTHER's with a "other_" prefix)
CASES = {
    "unbatched_sg_inner_product": LIGHT + tuple("other_" + k for k in LIGHT),
    "unbatched_reduced_sg_inner_product":
        LIGHT + tuple("other_" + k for k in LIGHT),
    "sg_irradiance_fitted": LIGHT + ("normals",),
    "sg_diffuse_fitted": LIGHT + ("normals", "albedo"),
    "sg_irradiance_inner_product": LIGHT + ("normals",),
    "sg_diffuse_inner_product": LIGHT + ("normals", "albedo"),
    "sg_warp_specular_term": LIGHT + ("normals", "roughness", "view",
                                      "albedo"),
    "sg_distribution_term": ("normals", "roughness"),
    "sg_warp_distribution": ("amplitude", "direction", "sharpness", "view"),
    "fresnel": ("ldh", "albedo"),
    "cosine_lobe_sg": ("normals",),
    "approximate_sg_integral": ("amplitude", "sharpness"),
    "sg_from_sun": ("direction", "strength", "angle", "amplitude"),
    "project_onto_sh9": ("normals",),
    "sh9_irradiance": ("sh", "normals"),
    "sh9_diffuse": ("sun", "normals", "albedo"),
}


def inputs(names):
    rng = np.random.RandomState(2)
    extra = {"ldh": rng.rand(32, 1).astype(np.float32),
             "strength": np.array([0.5, 2.0, 3.0, 8.0], np.float32),
             "angle": np.array([0.2, 0.5, 0.8, 1.4], np.float32),
             "sh": rng.randn(9).astype(np.float32),
             "sun": np.array([0.5, 0.7, 0.5], np.float32)}
    warped = {"amplitude": D["amplitude"][:1].repeat(32, 0),
              "direction": D["normals"], "sharpness": 2.0 / D["roughness"]}
    out = []
    for n in names:
        if n.startswith("other_"):
            out.append(OTHER[n[6:]])
        elif n in extra:
            out.append(extra[n])
        elif names == CASES["sg_warp_distribution"] and n in warped:
            out.append(warped[n].astype(np.float32))
        else:
            out.append(D[n])
    return out


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1.0))


GRAD_CASES = ("sg_warp_specular_term", "sg_diffuse_inner_product")
COTANGENT = np.random.RandomState(3).randn(32, 3).astype(np.float32)


def jax_value(name):
    return getattr(jl, name)(*[jnp.asarray(a) for a in inputs(CASES[name])])


def jax_gradient(name):
    """JAX's VJP of ``COTANGENT`` at ``bound_points``, in every input."""
    d = bound_points()
    fn = getattr(jl, name)
    return jax.grad(lambda *a: jnp.sum(fn(*a) * COTANGENT),
                    argnums=tuple(range(len(CASES[name]))))(
        *[jnp.asarray(d[n]) for n in CASES[name]])


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX value and gradient the module compares against, computed
    eagerly in threads at once: each eager op compiles on first use, and
    XLA compiles without the GIL."""
    jobs = {("value", n): (jax_value, n) for n in CASES}
    jobs.update({("grad", n): (jax_gradient, n) for n in GRAD_CASES})
    with ThreadPoolExecutor(8) as pool:
        futures = {k: pool.submit(f, n) for k, (f, n) in jobs.items()}
        return {k: fut.result() for k, fut in futures.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lighting_functions_match_jax(name, jax_results):
    args = inputs(CASES[name])
    want = jax_results["value", name]
    got = getattr(tl, name)(*[torch.from_numpy(np.array(a)) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


def bound_points():
    """Normals, views and a light whose terms land on the clip bounds: a
    view along the normal (n·v = 1), grazing views (n·v = 0, so the warped
    direction is −v, n·l = 0 and the half vector is 0), and a light channel
    of amplitude 0 (irradiance 0 in that channel)."""
    d = {k: v.copy() for k, v in D.items()}
    e = np.eye(3, dtype=np.float32)
    d["normals"][:4] = [e[2], e[2], e[0], e[1]]
    d["view"][:4] = [e[2], e[0], e[1], e[2]]
    d["amplitude"][:, 2] = 0.0
    return d


@pytest.mark.parametrize("name", GRAD_CASES)
def test_lighting_gradients_match_jax_at_the_bounds(name, jax_results):
    """The VJP of a seeded cotangent in every input, within 1e-5 of
    max|g|; ``jnp.clip`` splits the gradient at a bound, and so does the
    port's ``clip``."""
    d = bound_points()
    names = CASES[name]
    want = jax_results["grad", name]
    xs = [torch.from_numpy(d[n].copy()).requires_grad_(True) for n in names]
    torch.sum(getattr(tl, name)(*xs)
              * torch.from_numpy(COTANGENT)).backward()
    for n, x, w in zip(names, xs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            x.grad.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(np.abs(w).max(), 1e-30), err_msg=n)


def _env_fit_float64(img, lobes, sharpness):
    """The least-squares fit of ``from_environment_map`` in float64, from
    the float32 map, lobes and sharpness → amplitudes (num_sg, 3), and the
    basis (P, num_sg) that turns amplitudes into radiance at the map's
    pixel directions."""
    h, w = img.shape[:2]
    el = (0.5 - (np.arange(h) + 0.5) / h) * math.pi
    az = ((np.arange(w) + 0.5) / w - 0.5) * 2 * math.pi
    ce = np.cos(el)[:, None]
    dirs = np.stack([ce * np.cos(az)[None],
                     np.broadcast_to(np.sin(el)[:, None], (h, w)),
                     ce * np.sin(az)[None]], -1).reshape(-1, 3)
    weights = np.broadcast_to(ce, (h, w)).reshape(-1)
    basis = np.exp(sharpness.astype(np.float64)[None]
                   * (dirs @ lobes.astype(np.float64).T - 1.0))
    bw = basis * weights[:, None]
    ata = basis.T @ bw + 1e-6 * np.eye(len(lobes))
    return np.linalg.solve(ata, bw.T @ img.reshape(-1, 3)), basis


@pytest.mark.parametrize("num_sg,shape", [(8, (16, 32)), (32, (24, 48))])
def test_from_environment_map_matches_jax(num_sg, shape):
    """Lobes and sharpness within 1e-5; the radiance the fitted lights give
    at the map's pixels within 1e-5 of its largest value; the amplitudes
    within 1e-5 of the largest, or, where JAX's own float32 solve lies
    farther from the float64 solve of the same system (the 32 lobes' normal
    equations have a condition number of 456, which scales a summation
    order's rounding), no farther from it than JAX's."""
    rng = np.random.RandomState(4)
    img = rng.rand(*shape, 3).astype(np.float32)
    img[: shape[0] // 3] += 2.0
    fit = jax.jit(lambda x: vars(jl.SgLightingParameters.from_environment_map(
        x, num_sg=num_sg)))
    want = fit(jnp.asarray(img))
    got = tl.SgLightingParameters.from_environment_map(
        torch.from_numpy(img), num_sg=num_sg)
    for k in ("direction", "sharpness"):
        close(getattr(got, k), want[k])
    exact, basis = _env_fit_float64(img, np.asarray(want["direction"]),
                                    np.asarray(want["sharpness"]))
    amp, mine = np.asarray(want["amplitude"]), got.amplitude.numpy()
    radiance = basis @ amp
    np.testing.assert_allclose(basis @ mine, radiance, rtol=0,
                               atol=1e-5 * np.abs(radiance).max())
    scale = np.abs(exact).max()
    own = np.abs(amp - exact).max() / scale
    assert np.abs(mine - exact).max() / scale <= max(1e-5, own)
    if own <= 1e-5:
        np.testing.assert_allclose(mine, amp, rtol=0, atol=1e-5 * scale)


def test_lighting_parameters_match_jax():
    kw = dict(amplitude=D["amplitude"], direction=D["direction"] * 2.0,
              sharpness=D["sharpness"])
    want = jl.SgLightingParameters(**{k: jnp.asarray(v)
                                      for k, v in kw.items()})
    got = tl.SgLightingParameters(**{k: torch.from_numpy(v.copy())
                                     for k, v in kw.items()})
    for k in LIGHT:
        close(getattr(got, k), getattr(want, k))
    want = jl.SgLightingParameters(amplitude=2.0, direction=(0.0, 1.0, 1.0))
    got = tl.SgLightingParameters(amplitude=2.0, direction=(0.0, 1.0, 1.0),
                                  device="cpu")
    for k in LIGHT:
        close(getattr(got, k), getattr(want, k))
    sun = (np.array([[0.5, 0.7, 0.5], [-0.6, 0.2, 0.4]], np.float32),
           np.array([3.0, 0.6], np.float32))
    want = jl.SgLightingParameters.from_sun(jnp.asarray(sun[0]),
                                            jnp.asarray(sun[1]), angle=0.3)
    got = tl.SgLightingParameters.from_sun(torch.from_numpy(sun[0]),
                                           torch.from_numpy(sun[1]),
                                           angle=0.3)
    for k in LIGHT:
        close(getattr(got, k), getattr(want, k))
    jd = jl.sg_direction_from_azimuth_elevation(2.3, math.pi / 3.0)
    close(tl.sg_direction_from_azimuth_elevation(2.3, math.pi / 3.0,
                                                 device="cpu"), jd)
    jdef, tdef = (__import__("kaolin_tpu.render.easy_render",
                             fromlist=["x"]).default_lighting(),
                  default_lighting("cpu"))
    for k in LIGHT:
        close(getattr(tdef, k), getattr(jdef, k))
        close(getattr(sg_lighting_from_jax(jdef), k), getattr(jdef, k), 0)


def test_defaults_run_on_the_card_unless_the_cpu_is_named():
    """Without a device the defaults and the lights made from numbers go
    to the CUDA device; on a machine without one they raise and name
    ``device='cpu'``. Tensors keep theirs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for make in (default_lighting, default_camera, default_material,
                 tl.SgLightingParameters,
                 lambda: tl.sg_direction_from_azimuth_elevation(0.1, 0.2),
                 lambda: tl.project_onto_sh9([0.0, 1.0, 0.0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert default_camera(64, device="cpu").extrinsics.device.type == "cpu"
    light = tl.SgLightingParameters(direction=torch.ones(2, 3))
    assert light.amplitude.shape == (2, 3) and light.direction.device.type \
        == "cpu"


def _material_kwargs():
    rng = np.random.RandomState(5)
    return dict(material_name="m", is_specular_workflow=True,
                diffuse_color=(0.2, 0.3, 0.4), roughness_value=0.5,
                metallic_value=np.float32(0.1),
                diffuse_texture=rng.rand(3, 4, 5).astype(np.float32),
                normals_texture=rng.rand(3, 4, 5).astype(np.float32),
                roughness_texture=rng.rand(1, 4, 5).astype(np.float32),
                specular_colorspace="raw")


def _same_material(got, want):
    assert got.get_attributes() == want.get_attributes()
    for a in want.get_attributes():
        w, g = getattr(want, a), getattr(got, a)
        if a in tmat._VALUE_ATTRS + tmat._TEXTURE_ATTRS:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert g == w


def test_pbr_material_matches_jax():
    kw = _material_kwargs()
    want, got = jmat.PBRMaterial(**kw), tmat.PBRMaterial(**kw)
    _same_material(got, want)
    _same_material(got.hwc(), want.hwc())
    _same_material(got.hwc().chw(), want)
    _same_material(pbr_material_from_jax(want), want)
    assert got.get_attributes(only_tensors=True) == \
        want.get_attributes(only_tensors=True)
    assert repr(got) == repr(want)
    assert (tmat.PBRMaterial.supported_tensor_attributes()
            == jmat.PBRMaterial.supported_tensor_attributes())
    assert (tmat.PBRMaterial.supported_texture_attributes()
            == jmat.PBRMaterial.supported_texture_attributes())
    with pytest.raises(TypeError):
        tmat.PBRMaterial(bogus=1)
    t = torch.ones(3, 2, 2, requires_grad=True)
    assert tmat.PBRMaterial(diffuse_texture=t).diffuse_texture is t
    _same_material(default_material(device="cpu"),
                   __import__("kaolin_tpu.render.easy_render",
                              fromlist=["x"]).default_material())


def test_random_materials_keep_their_contracts():
    """Without a key, the JAX package's values; from a ``torch.Generator``,
    the same values for the same seed and others for another; the shapes,
    float32 and [0, 1); 'auto' or 'raw' in every colorspace slot."""
    for name in ("random_material_values", "random_material_textures"):
        want = getattr(jmat, name)()
        got = getattr(tmat, name)()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        a = getattr(tmat, name)(torch.Generator().manual_seed(1))
        b = getattr(tmat, name)(torch.Generator().manual_seed(1))
        c = getattr(tmat, name)(torch.Generator().manual_seed(2))
        for k in want:
            assert a[k].shape == want[k].shape and a[k].dtype == np.float32
            assert ((a[k] >= 0) & (a[k] < 1)).all()
            np.testing.assert_array_equal(a[k], b[k])
            assert not np.array_equal(a[k], c[k])
        tmat.PBRMaterial(**a)
    spaces = tmat.random_material_colorspaces(torch.Generator().manual_seed(0))
    assert spaces.keys() == jmat.random_material_colorspaces(
        jax.random.PRNGKey(0)[0]).keys()
    assert set(spaces.values()) <= {"auto", "raw"}
    assert tmat.random_material_colorspaces(
        torch.Generator().manual_seed(0)) == spaces
    assert tmat.PBRMaterial(**spaces).get_attributes() == \
        tmat.PBRMaterial().get_attributes()
