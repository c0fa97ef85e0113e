"""kaolin_tpu_torch physics building blocks against kaolin_tpu's, on the CPU.

The same numpy inputs, from seeded ``RandomState``s, go to both packages:
materials, the dense operators, the scene forces, the skinning module with
MLP weights carried across by ``simplicits_mlp_from_jax``, the line-search
automaton and Newton's method. Tolerances: elementwise formulas rtol 1e-5
and atol 1e-6 (both packages compute them op for op in float32; sums and
products over a contraction may round in another order); the automaton
exactly; Newton's result rtol 1e-4 (a solve and a line search compound the
rounding).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.physics.common import optimization as opt_jax
from kaolin_tpu.physics.common import scene_forces as forces_jax
from kaolin_tpu.physics.materials import linear_elastic_material as lin_jax
from kaolin_tpu.physics.materials import material_utils as mu_jax
from kaolin_tpu.physics.materials import neohookean_elastic_material as nh_jax
from kaolin_tpu.physics.simplicits import network as net_jax
from kaolin_tpu.physics.simplicits import precomputed as pre_jax
from kaolin_tpu.physics.simplicits.skinning import standard_lbs as lbs_jax
from kaolin_tpu.physics.utils import finite_diff as fd_jax
from kaolin_tpu.physics.utils import torch_utilities as tu_jax
from kaolin_tpu_torch.physics.common import optimization as opt
from kaolin_tpu_torch.physics.common import scene_forces as forces
from kaolin_tpu_torch.physics.materials import linear_elastic_material as lin
from kaolin_tpu_torch.physics.materials import material_utils as mu
from kaolin_tpu_torch.physics.materials import (
    neohookean_elastic_material as nh,
)
from kaolin_tpu_torch.physics.simplicits import (
    PhysicsPoints,
    SimplicitsObject,
    SkinningModule,
    precomputed as pre,
)
from kaolin_tpu_torch.physics.simplicits.skinning import standard_lbs
from kaolin_tpu_torch.physics.utils import finite_diff as fd
from kaolin_tpu_torch.physics.utils import torch_utilities as tu
from kaolin_tpu_torch.utils.interop import simplicits_mlp_from_jax

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def near_identity(n=64, seed=0, scale=0.1):
    """n deformation gradients I + scale·N(0, 1), float32."""
    rng = np.random.RandomState(seed)
    return (np.eye(3) + scale * rng.randn(n, 3, 3)).astype(np.float32)


def lame(n=64, seed=1):
    rng = np.random.RandomState(seed)
    yms = rng.uniform(1e3, 1e5, n).astype(np.float32)
    prs = rng.uniform(0.1, 0.45, n).astype(np.float32)
    vol = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    return yms, prs, vol


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---- materials ------------------------------------------------------------

def test_det_inv_adjugate_and_to_lame():
    F = near_identity(scale=0.3)
    close(mu.det_3x3(t(F)), mu_jax.det_3x3(jnp.asarray(F)))
    close(mu.adjugate_3x3(t(F)), mu_jax.adjugate_3x3(jnp.asarray(F)))
    close(mu.inv_3x3(t(F)), mu_jax.inv_3x3(jnp.asarray(F)))
    close(mu.inv_3x3(t(F)) @ t(F), np.broadcast_to(np.eye(3), F.shape),
          atol=1e-5)
    yms, prs, _ = lame()
    for got, want in zip(mu.to_lame(t(yms), t(prs)),
                         mu_jax.to_lame(jnp.asarray(yms), jnp.asarray(prs))):
        close(got, want)
    rng = np.random.RandomState(2)
    z = rng.randn(24).astype(np.float32)
    dFdz = rng.randn(9 * 5, 24).astype(np.float32)
    close(mu.get_defo_grad(t(z), t(dFdz)),
          mu_jax.get_defo_grad(jnp.asarray(z), jnp.asarray(dFdz)),
          rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["energy", "gradient", "hessian"])
def test_neohookean_matches_jax(name):
    F = near_identity()
    yms, prs, vol = lame()
    mus, lams = mu_jax.to_lame(yms, prs)
    args = [np.asarray(mus)[:, None], np.asarray(lams)[:, None], F,
            vol[:, None]]
    got = getattr(nh, f"neohookean_{name}")(*map(t, args))
    want = getattr(nh_jax, f"neohookean_{name}")(*map(jnp.asarray, args))
    assert got.shape == want.shape
    close(got, want, atol=1e-6 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("name", ["energy", "gradient", "hessian"])
def test_neohookean_material_object_matches_jax(name):
    F = near_identity(seed=3, scale=0.2)
    yms, prs, vol = lame(seed=4)
    mus, lams = (np.asarray(x) for x in mu_jax.to_lame(yms, prs))
    m = nh.NeohookeanElasticMaterial(t(mus), t(lams), t(vol),
                                     reparameterize_lame=True)
    mj = nh_jax.NeohookeanElasticMaterial(jnp.asarray(mus), jnp.asarray(lams),
                                          jnp.asarray(vol),
                                          reparameterize_lame=True)
    got = getattr(m, name)(t(F), coeff=2.0)
    want = getattr(mj, name)(jnp.asarray(F), coeff=2.0)
    close(got, want, atol=1e-6 * float(np.abs(np.asarray(want)).max()))
    if name == "energy":   # a batch of F sets: one energy each
        batch = m.energy(t(np.stack([F, F[::-1]])), coeff=2.0)
        close(batch[0], want, atol=1e-3)
        assert batch.shape == (2,)


@pytest.mark.parametrize("name", ["energy", "gradient"])
def test_linear_elastic_matches_jax(name):
    F = near_identity(seed=5)
    yms, prs, _ = lame(seed=6)
    mus, lams = (np.asarray(x)[:, None] for x in mu_jax.to_lame(yms, prs))
    got = getattr(lin, f"linear_elastic_{name}")(t(mus), t(lams), t(F))
    want = getattr(lin_jax, f"linear_elastic_{name}")(
        jnp.asarray(mus), jnp.asarray(lams), jnp.asarray(F))
    close(got, want, atol=1e-6 * float(np.abs(np.asarray(want)).max()))
    close(lin.cauchy_strain(t(F)), lin_jax.cauchy_strain(jnp.asarray(F)))


# ---- operators --------------------------------------------------------------

def skin_case(n=40, h=5, seed=7):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    w = rng.rand(n, h).astype(np.float32)
    dwdx = rng.randn(n, h, 3).astype(np.float32)
    return x0, w, dwdx


def test_lbs_and_dFdz_matrices_match_jax():
    x0, w, dwdx = skin_case()
    B = pre.lbs_matrix(t(x0), t(w))
    assert B.shape == (3 * 40, 12 * 5)
    np.testing.assert_array_equal(B.numpy(), np.asarray(
        pre_jax.lbs_matrix(jnp.asarray(x0), jnp.asarray(w))))
    close(pre.dFdz_matrix(t(w), t(dwdx), t(x0)),
          pre_jax.dFdz_matrix(jnp.asarray(w), jnp.asarray(dwdx),
                              jnp.asarray(x0)))


def test_dFdz_matches_its_autodiff_oracle():
    """dFdz_matrix of an analytic skinning module against jacobian_dF_dz
    (torch.func through the module), and the module's exact dwdx against
    JAX's."""
    rng = np.random.RandomState(8)
    freqs = rng.randn(3, 3).astype(np.float32)
    x0 = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32)
    skin = SkinningModule.from_function(lambda x: torch.sin(x @ t(freqs)),
                                        bb_min=-1.0, bb_max=1.0)
    skin_j = net_jax.SkinningFn.from_function(
        lambda x: jnp.sin(x @ jnp.asarray(freqs)), bb_min=-1.0, bb_max=1.0)
    w = skin.compute_skinning_weights(t(x0))
    dwdx = skin.compute_dwdx(t(x0))
    close(w, skin_j.compute_skinning_weights(jnp.asarray(x0)))
    close(dwdx, skin_j.compute_dwdx(jnp.asarray(x0)))
    z = torch.zeros(12 * 4)
    close(pre.jacobian_dF_dz(skin, t(x0), z), pre.dFdz_matrix(w, dwdx, t(x0)),
          atol=1e-5)


def test_standard_lbs_and_hess_reduction_match_jax():
    x0, w, _ = skin_case(seed=9)
    rng = np.random.RandomState(10)
    tfms = rng.randn(2, 5, 3, 4).astype(np.float32)
    close(standard_lbs(t(x0), t(tfms), t(w)),
          lbs_jax(jnp.asarray(x0), jnp.asarray(tfms), jnp.asarray(w)))
    ja = rng.randn(40 * 9, 17).astype(np.float32)
    jb = rng.randn(40 * 9, 11).astype(np.float32)
    h = rng.randn(40, 9, 9).astype(np.float32)
    for args in ((ja, h), (ja, h, jb)):
        got = tu.hess_reduction(*map(t, args))
        want = tu_jax.hess_reduction(*map(jnp.asarray, args))
        close(got, want, rtol=1e-5, atol=1e-4)


def test_small_utilities_match_jax():
    rng = np.random.RandomState(11)
    tf = rng.randn(4, 4).astype(np.float32)
    close(tu.standard_transform_to_relative(t(tf)),
          tu_jax.standard_transform_to_relative(jnp.asarray(tf)))
    np.testing.assert_array_equal(tu.create_projection_mask(10, [2, 5]),
                                  tu_jax.create_projection_mask(10, [2, 5]))
    np.testing.assert_array_equal(
        tu.create_projection_matrix(10, [2, 5]).numpy(),
        np.asarray(tu_jax.create_projection_matrix(10, [2, 5])))
    rhos = rng.uniform(100, 1000, 7).astype(np.float32)
    for got, want in zip(pre.lumped_mass_matrix(t(rhos), 2.0),
                         pre_jax.lumped_mass_matrix(jnp.asarray(rhos), 2.0)):
        close(got, want)
    x = rng.randn(6, 3).astype(np.float32)
    freqs = rng.randn(3, 4).astype(np.float32)
    close(fd.finite_diff_jac(lambda p: torch.sin(p @ t(freqs)), t(x)),
          fd_jax.finite_diff_jac(lambda p: jnp.sin(p @ jnp.asarray(freqs)),
                                 jnp.asarray(x)), rtol=1e-3, atol=1e-3)


# ---- scene forces -----------------------------------------------------------

def force_case(n=50, seed=12):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-1.5, 0.5, (n, 3)).astype(np.float32)
    dx = (0.3 * rng.randn(n, 3)).astype(np.float32)
    rho = rng.uniform(100, 1000, n).astype(np.float32)
    vol = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    return x0, dx, rho, vol


def make_forces(pkg, x0, rho, vol):
    """Gravity, a floor below at y = -1, a ceiling above at x = 0.2 (flip)
    and a boundary pinning 7 points, from package ``pkg``."""
    arr = t if pkg is forces else jnp.asarray
    out = [pkg.Gravity(arr(np.float32([0.0, 9.8, 0.3])), arr(rho), arr(vol)),
           pkg.Floor(-1.0, 1, False, arr(vol)),
           pkg.Floor(0.2, 0, True, arr(vol))]
    idx = np.arange(0, 50, 7)
    out.append(pkg.Boundary(arr(vol)).set_pinned(arr(idx),
                                                 arr(x0[idx] + 0.05)))
    return out


@pytest.mark.parametrize("kind", ["gravity", "floor", "ceiling", "boundary"])
@pytest.mark.parametrize("name", ["energy", "gradient", "hessian"])
def test_scene_forces_match_jax(kind, name):
    x0, dx, rho, vol = force_case()
    k = ["gravity", "floor", "ceiling", "boundary"].index(kind)
    f = make_forces(forces, x0, rho, vol)[k]
    fj = make_forces(forces_jax, x0, rho, vol)[k]
    got = getattr(f, name)(t(dx), t(x0), coeff=3.0)
    want = getattr(fj, name)(jnp.asarray(dx), jnp.asarray(x0), coeff=3.0)
    assert tuple(got.shape) == tuple(np.shape(want))
    close(got, want, rtol=1e-5, atol=1e-5)
    if name == "energy":   # a batch of displacements: one energy each
        batch = f.energy(t(np.stack([dx, 2 * dx])), t(x0), coeff=3.0)
        close(batch[0], got)


# ---- skinning module with JAX MLP weights -----------------------------------

def test_mlp_weights_from_jax():
    params = net_jax.mlp_init(jax.random.PRNGKey(3), 3, 16, 6, 2)
    bb_min, bb_max = np.float32([-1, -0.5, -2]), np.float32([1, 1.5, 0.5])
    skin_j = net_jax.SkinningFn(params=params, bb_min=bb_min, bb_max=bb_max)
    skin = simplicits_mlp_from_jax(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in params],
        bb_min=bb_min, bb_max=bb_max)
    assert len(skin.layers) == 4 and skin.layers[0].weight.shape == (16, 3)
    x = np.random.RandomState(13).uniform(-1, 1, (30, 3)).astype(np.float32)
    with torch.no_grad():
        close(skin(t(x)), skin_j(jnp.asarray(x)))
        close(skin.compute_skinning_weights(t(x)),
              skin_j.compute_skinning_weights(jnp.asarray(x)))
    close(skin.compute_dwdx(t(x)), skin_j.compute_dwdx(jnp.asarray(x)),
          rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="fit"):
        bad = [dict(layer) for layer in params]
        bad[1] = {"w": np.zeros((16, 8), np.float32),
                  "b": np.zeros(8, np.float32)}
        simplicits_mlp_from_jax(bad)


def test_objects_bake_as_jax_bakes():
    """An analytic skinning function baked at 20 of 60 points (the same
    seeded subsample) gives JAX's weights and exact dwdx; a rigid object
    bakes the constant handle alone."""
    from kaolin_tpu.physics.simplicits import PhysicsPoints as PPJ
    from kaolin_tpu.physics.simplicits import SimplicitsObject as SOJ
    rng = np.random.RandomState(14)
    pts = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    freqs = rng.randn(3, 4).astype(np.float32)
    obj = SimplicitsObject.create_from_function(
        PhysicsPoints(pts, 1e4, 0.45, 500.0, 1.0),
        lambda x: torch.sin(x @ t(freqs)))
    obj_j = SOJ.create_from_function(
        PPJ(pts, 1e4, 0.45, 500.0, 1.0), lambda x: jnp.sin(x @ freqs))
    baked, baked_j = obj.bake(num_qps=20), obj_j.bake(num_qps=20)
    np.testing.assert_array_equal(baked.pts.numpy(), np.asarray(baked_j.pts))
    close(baked.skinning_weights, baked_j.skinning_weights)
    close(baked.dwdx, baked_j.dwdx)
    close(baked.yms, baked_j.yms)
    rigid = SimplicitsObject.create_rigid(obj).bake(sampling_indices=[1, 4])
    assert rigid.skinning_weights.shape == (2, 1)
    assert not rigid.dwdx.any() and rigid.dwdx.shape == (2, 1, 3)
    rend = obj.bake_for_rendering(t(pts[:5]))
    close(rend.skinning_weights,
          obj_j.bake_for_rendering(jnp.asarray(pts[:5])).skinning_weights)
    for make in (SimplicitsObject.create_with_mlp,
                 SimplicitsObject.create_with_rkpm):
        with pytest.raises(NotImplementedError, match="Queue A 2"):
            make(obj, 4, 100)


# ---- the line search ---------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_line_search_automaton_matches_jax_on_every_pattern(m):
    n = 2 * m + 1
    bits = np.array(list(itertools.product([False, True], repeat=n)))
    want = np.asarray(jax.vmap(
        lambda s: opt_jax._resolve_ls_automaton(s, m))(jnp.asarray(bits)))
    got = opt._resolve_ls_automaton(torch.from_numpy(bits), m)
    assert len(bits) == 2 ** n
    np.testing.assert_array_equal(got.numpy(), want)
    # one pattern at a time, as the line search calls it
    for row in bits[:: max(1, len(bits) // 16)]:
        one = opt._resolve_ls_automaton(torch.from_numpy(row), m)
        assert int(one) == int(opt_jax._resolve_ls_automaton(
            jnp.asarray(row), m))


@pytest.mark.parametrize("qr", [False, True])
def test_line_search_step_grid_and_bounds_match_jax(qr):
    """The step-size grid bit for bit, and the bounded steps on it."""
    m, beta = 10, 0.6
    ts = opt._step_sizes(beta, m, torch.float32, "cpu")
    grow = jnp.cumprod(jnp.full((m,), 1.0 / beta, dtype=jnp.float32))[::-1]
    shrink = jnp.cumprod(jnp.full((m,), beta, dtype=jnp.float32))
    want_ts = np.asarray(jnp.concatenate([grow, jnp.ones(1), shrink]))
    np.testing.assert_array_equal(ts.numpy(), want_ts)
    rng = np.random.RandomState(15)
    d = rng.randn(8).astype(np.float32)
    bounds = rng.uniform(0.2, 2.0, 8).astype(np.float32)
    q = np.linalg.qr(rng.randn(8, 8))[0].astype(np.float32) if qr else None
    qi = q.T.copy() if qr else None
    got = opt._apply_bounds(t(d), t(bounds), ts, *(
        (t(q), t(qi)) if qr else (None, None)))
    want = jax.vmap(lambda s: opt_jax._apply_bounds(
        jnp.asarray(d), jnp.asarray(bounds), s,
        *((jnp.asarray(q), jnp.asarray(qi)) if qr else (None, None))))(
            jnp.asarray(want_ts))
    close(got, want, rtol=1e-5, atol=1e-5)


# ---- Newton's method ---------------------------------------------------

def newton_problem(seed=16):
    """A one-object Neo-Hookean problem: 30 points and 2 handles (24 DOFs),
    inertia M = BᵀB/dt² pulling z to z0, a load f, and an elastic energy
    of F = I + dFdz z."""
    rng = np.random.RandomState(seed)
    n, h = 30, 2
    x0 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    w = np.concatenate([np.sin(x0 @ rng.randn(3, h - 1)),
                        np.ones((n, 1))], 1).astype(np.float32)
    dwdx = np.zeros((n, h, 3), np.float32)
    dwdx[:, 0] = rng.randn(n, 3)
    yms, prs, vol = lame(n, seed=17)
    mus, lams = (np.asarray(x) for x in mu_jax.to_lame(yms, prs))
    return {"B": np.asarray(pre_jax.lbs_matrix(x0, w)),
            "dFdz": np.asarray(pre_jax.dFdz_matrix(w, dwdx, x0)),
            "mus": mus, "lams": lams, "vol": vol,
            "f": (50.0 * rng.randn(12 * h)).astype(np.float32),
            "z0": (0.01 * rng.randn(12 * h)).astype(np.float32)}


def newton_fns(p, pkg):
    """(energy, gradient, Hessian) of the problem in package ``pkg``."""
    jx = pkg is nh_jax
    arr = jnp.asarray if jx else t
    B, dFdz, f, z0 = (arr(p[k]) for k in ("B", "dFdz", "f", "z0"))
    mat = pkg.NeohookeanElasticMaterial(arr(p["mus"]), arr(p["lams"]),
                                        arr(p["vol"]))
    M = B.T @ B * 1e4
    eye = (jnp.eye if jx else torch.eye)(3)
    hr = tu_jax.hess_reduction if jx else tu.hess_reduction

    def F_of(z):
        return (dFdz @ z).reshape(-1, 3, 3) + eye

    def energy(z):
        dz = z - z0
        return 0.5 * dz @ (M @ dz) + mat.energy(F_of(z)) - f @ z

    def gradient(z):
        return M @ (z - z0) + dFdz.T @ mat.gradient(F_of(z)).reshape(-1) - f

    def hessian(z):
        return M + hr(dFdz, mat.hessian(F_of(z)))

    return energy, gradient, hessian


@pytest.mark.parametrize("direct_solve", [True, False])
@pytest.mark.parametrize("kinematic", [False, True])
def test_newtons_method_matches_jax(direct_solve, kinematic):
    p = newton_problem()
    dyn = np.arange(12, 24) if kinematic else None
    kw = dict(dyn_idx=dyn, nm_max_iters=5, direct_solve=direct_solve,
              cg_iters=60)
    x0 = np.zeros(24, np.float32)
    x0[:12] = 0.02
    want = np.asarray(opt_jax.newtons_method(
        jnp.asarray(x0), *newton_fns(p, nh_jax), **kw))
    got = opt.newtons_method(t(x0), *newton_fns(p, nh), **kw)
    fixed = opt.newtons_method(t(x0), *newton_fns(p, nh),
                               differentiable=True, **kw)
    assert np.abs(want - x0).max() > 1e-3     # Newton moved
    close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    assert torch.equal(fixed.view(torch.int32), got.view(torch.int32))
    if kinematic:
        np.testing.assert_array_equal(got.numpy()[:12], x0[:12])
        # the index as a tensor (the scene's form: no host copy in a step)
        kw["dyn_idx"] = torch.as_tensor(dyn)
        as_tensor = opt.newtons_method(t(x0), *newton_fns(p, nh), **kw)
        assert torch.equal(as_tensor.view(torch.int32), got.view(torch.int32))


def test_direct_solve_falls_back_to_lu_where_cholesky_fails():
    """An SPD H takes the Cholesky solution, an indefinite one the LU
    solution, as the JAX package's solve does (its Cholesky gives NaN
    there)."""
    rng = np.random.RandomState(18)
    a = rng.randn(12, 12).astype(np.float32)
    g = rng.randn(12).astype(np.float32)
    spd = a @ a.T / 12 + np.eye(12, dtype=np.float32)
    ind = (a + a.T).astype(np.float32)
    for h in (spd, ind):
        got = opt._direct_solve(t(h), t(g))
        close(t(h) @ got, g, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        opt._direct_solve(t(ind), t(g)).numpy(),
        torch.linalg.solve(t(ind), t(g)).numpy())
    L = torch.linalg.cholesky(t(spd).mT)     # H's upper triangle
    chol = torch.cholesky_solve(t(g)[:, None], L)[:, 0]
    np.testing.assert_array_equal(opt._direct_solve(t(spd), t(g)).numpy(),
                                  chol.numpy())
    # the CUDA graph's form: the Cholesky solution kept, failures flagged
    failed = torch.zeros((), dtype=torch.bool)
    with opt.cholesky_only(failed):
        kept = opt._direct_solve(t(spd), t(g))
        assert not bool(failed)
        opt._direct_solve(t(ind), t(g))
    assert bool(failed) and torch.equal(kept, chol)
    # with the LU in the graph: the eager solve's result, bit for bit
    failed = torch.zeros((), dtype=torch.bool)
    with opt.cholesky_only(failed, with_lu=True):
        for h in (spd, ind):
            assert torch.equal(opt._direct_solve(t(h), t(g)),
                               eager_solve(t(h), t(g)))
    assert bool(failed)


def eager_solve(h, g):
    """``_direct_solve`` outside any graph context."""
    token = opt._FAILED.set(None)
    try:
        return opt._direct_solve(h, g)
    finally:
        opt._FAILED.reset(token)


def test_direct_solve_reads_the_upper_triangle_as_jax():
    """Fault F15: the JAX solve factors H's upper triangle
    (``cho_factor(lower=False)``); the port factored the lower. With
    contact H is not symmetric (friction), and the two solve other
    systems. On a non-symmetric positive definite H the port's solution is
    JAX's to rounding (the lower triangle's is 1e-2 away)."""
    rng = np.random.RandomState(3)
    a = rng.randn(6, 6).astype(np.float32)
    h = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    h[0, 3] += 2.0
    g = rng.randn(6).astype(np.float32)
    want = np.asarray(jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(jnp.asarray(h)), jnp.asarray(g)))
    got = opt._direct_solve(t(h), t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    lower = torch.cholesky_solve(t(g)[:, None], torch.linalg.cholesky(t(h))
                                 )[:, 0].numpy()
    assert np.abs(lower - want).max() > 1e-3
