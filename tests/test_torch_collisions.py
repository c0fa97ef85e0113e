"""kaolin_tpu_torch's ``Collision`` against kaolin_tpu's, on the CPU.

Both packages get the same numpy inputs (``tests/physics/test_collisions.py``'s
random scenes: three clouds of 60 points). The JAX detection runs under
``jax.jit``, as the sim step runs it. A port ``Collision`` is made from the
configured JAX one (``collision_from_jax``), so both detect over the same
grid. Pair sets are held exactly; a pair whose squared distance sat on the
detection radius to within rounding would be reported with its d².

The contact terms are held on one contact buffer that JAX detected and
``contacts_from_jax`` carried over, within 1e-5 of each output's largest
entry; the q-form within the port against its gather form and an explicit
jacobian, with the JAX file's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.physics.common.collisions import Collision as CollisionJax
from kaolin_tpu.physics.simplicits.precomputed import (
    lbs_matrix as lbs_matrix_jax,
)
from kaolin_tpu_torch.physics.common import Collision, Contacts
from kaolin_tpu_torch.physics.common import collisions as col_mod
from kaolin_tpu_torch.physics.simplicits.precomputed import lbs_matrix
from kaolin_tpu_torch.physics.utils.torch_utilities import hess_reduction
from kaolin_tpu_torch.utils.interop import (
    collision_from_jax,
    contacts_from_jax,
)
from kaolin_tpu_torch.utils.numerics import nonzero_static
from tests.torch_parity import pair_set, random_contact_scene
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

TERM_TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def jax_detect(col, *args, return_diag=False, **arrays):
    """JAX's detection under jit, its Collision closed over (its floats
    Python constants, as the port's are); ``arrays`` (weights, cp_exclude)
    go in as arguments."""
    def run(a, kw):
        return col.detect_collisions(*a, return_diag=return_diag, **kw)
    return jax.jit(run)(args, arrays)


def jax_diag(col, *args):
    return jax.jit(lambda *a: col.detection_diagnostics(*a))(*args)


def near_radius(col, dx, x0, got, want):
    """The squared distances of the pairs one side found and the other did
    not, beside the squared radius: the report of a rounding tie."""
    cur = x0 + dx
    return [(p, float(((cur[p[0]] - cur[p[1]]) ** 2).sum()))
            for p in got ^ want], col.detection_radius ** 2


# seeds of tests/physics/test_collisions.py: grid and dense take 0 and 3
# (its seeds 1 and 2 hold no pair at radius 0.05 or 0.15 but seed 2's 3),
# the sweep 0 and 2 of its sweep cases
CASES = [(bp, seed, radius) for bp, seeds in (("dense", (0, 3)),
                                              ("grid", (0, 3)),
                                              ("sweep", (0, 2)))
         for seed in seeds for radius in (0.05, 0.15)]


@pytest.mark.parametrize("broad_phase,seed,radius", CASES)
def test_contact_set_matches_jax(broad_phase, seed, radius):
    """The same pair set as JAX, exactly, and the port's grid and sweep
    give the port's dense set; with weights the q-form factors agree."""
    dx, x0, ids = random_contact_scene(seed)
    kw = dict(dt=0.01, collision_particle_radius=radius,
              detection_ratio=1.5, max_contacting_pairs=4000)
    cj = CollisionJax(broad_phase=broad_phase, **kw)
    if broad_phase == "grid":
        cj.configure_grid(x0, obj_ids=ids)
    ct = collision_from_jax(cj)
    w = np.random.RandomState(seed + 10).uniform(
        0.05, 1.0, (len(x0), 4)).astype(np.float32)
    want = jax_detect(cj, dx, x0, ids, weights=w)
    got = ct.detect_collisions(t(dx), t(x0), t(ids), weights=t(w))
    s_want, s_got = pair_set(want), pair_set(got)
    assert s_got == s_want, near_radius(ct, dx, x0, s_got, s_want)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    dense = Collision(broad_phase="dense", **kw).detect_collisions(
        t(dx), t(x0), t(ids))
    assert pair_set(dense) == s_got
    for name in ("normals", "kinematic_gaps", "wa", "wb", "xa", "xb", "qat",
                 "qbt"):
        # per pair, in either package's order
        g = getattr(got, name).numpy()
        j = np.asarray(getattr(want, name))
        if name.startswith("q"):
            g, j = g.T, j.T
        order = lambda c: np.lexsort((np.asarray(c.indices_b),  # noqa: E731
                                      np.asarray(c.indices_a),
                                      ~np.asarray(c.valid)))
        np.testing.assert_allclose(g[order(got)], j[order(want)], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_contact_sets_are_not_empty():
    """The cases above hold pairs: seed 0 at both radii, seeds 2 and 3 at
    0.15 (seed 3 at 0.05 checks an empty set)."""
    counts = {}
    for seed in (0, 2, 3):
        dx, x0, ids = random_contact_scene(seed)
        for radius in (0.05, 0.15):
            col = Collision(dt=0.01, collision_particle_radius=radius,
                            max_contacting_pairs=4000)
            counts[seed, radius] = len(pair_set(col.detect_collisions(
                t(dx), t(x0), t(ids))))
    assert counts == {(0, 0.05): 10, (0, 0.15): 362, (2, 0.05): 0,
                      (2, 0.15): 3, (3, 0.05): 0, (3, 0.15): 27}


@pytest.mark.parametrize("case", ["seed0", "seed3_r05", "no_ids",
                                  "margin_headroom", "bounds_pts",
                                  "fixed_capacities"])
def test_configure_grid_matches_jax(case):
    """The grid's dims, origin, cell side, K, M and per-point fan-out
    capacity equal JAX's on the same points."""
    seed = 3 if case == "seed3_r05" else 0
    dx, x0, ids = random_contact_scene(seed)
    radius = 0.05 if case == "seed3_r05" else 0.15
    kw = dict(obj_ids=None if case == "no_ids" else ids)
    if case == "margin_headroom":
        kw.update(margin=0.1, headroom=2.25, headroom_k=1.25)
    if case == "bounds_pts":
        kw.update(bounds_pts=x0 * 1.5, headroom=3.0)
    if case == "fixed_capacities":
        kw.update(auto_capacities=False)
    cj = CollisionJax(dt=0.01, collision_particle_radius=radius,
                      broad_phase="grid")
    ct = Collision(dt=0.01, collision_particle_radius=radius,
                   broad_phase="grid")
    cj.configure_grid(x0 + dx, **kw)
    ct.configure_grid(x0 + dx, **kw)
    assert ct.grid_dims == cj.grid_dims
    assert ct.grid_cell == cj.grid_cell
    np.testing.assert_array_equal(ct.grid_origin, np.asarray(cj.grid_origin))
    for name in ("cell_capacity", "max_occupied_cells",
                 "point_contact_capacity"):
        assert getattr(ct, name) == getattr(cj, name), name


def diag_of(diag):
    return {k: int(np.asarray(v)) for k, v in diag.items()}


def test_overflow_diagnostics_match_jax():
    """``tests/physics/test_collisions.py``'s overflow cases: a 2-pair
    buffer, one point a cell, two occupied cells, and the measured
    capacities; every diagnostic and the bitmask as JAX's."""
    dx, x0, ids = random_contact_scene(0)
    seen = []
    for name, value in (("max_contacts", 2), ("cell_capacity", 1),
                        ("max_occupied_cells", 2), (None, None)):
        cj = CollisionJax(dt=0.01, collision_particle_radius=0.15,
                          broad_phase="grid", max_contacting_pairs=4000)
        cj.configure_grid(x0, obj_ids=ids if name is None else None)
        if name is not None:
            setattr(cj, name, value)
        ct = collision_from_jax(cj)
        want = jax_diag(cj, dx, x0, ids)
        got = ct.detection_diagnostics(t(dx), t(x0), t(ids))
        assert diag_of(got) == diag_of(want), name
        flags = int(Collision.diag_flags(got))
        assert flags == int(CollisionJax.diag_flags(want)), name
        seen.append(flags)
    assert seen[0] & Collision.FLAG_CONTACTS_OVERFLOW
    assert seen[1] & Collision.FLAG_CELL_OVERFLOW
    assert seen[2] & Collision.FLAG_OCC_OVERFLOW
    assert seen[3] == 0


def test_sweep_window_overflow_matches_jax():
    """All points in a thin x-slab: a 4-point window overflows, 128 does
    not; the window load as JAX's."""
    rng = np.random.RandomState(0)
    x0 = np.stack([np.zeros(100), rng.rand(100), rng.rand(100)],
                  1).astype(np.float32)
    dx = np.zeros_like(x0)
    ids = (np.arange(100) % 2).astype(np.int32)
    for window, over in ((4, 1), (128, 0)):
        cj = CollisionJax(dt=0.01, collision_particle_radius=0.1,
                          broad_phase="sweep", sweep_window=window,
                          max_contacting_pairs=8000)
        want = jax_diag(cj, dx, x0, ids)
        got = collision_from_jax(cj).detection_diagnostics(t(dx), t(x0),
                                                           t(ids))
        assert diag_of(got) == diag_of(want)
        assert diag_of(got)["window_overflow"] == over


def test_pp_overflow_matches_jax():
    """A starved per-point fan-out (capacity 1) reports its dropped pairs
    and bit as JAX does; at the measured capacity nothing drops and the
    grid's pairs are the dense set."""
    dx, x0, ids = random_contact_scene(0)
    cj = CollisionJax(dt=0.01, collision_particle_radius=0.15,
                      broad_phase="grid", max_contacting_pairs=4000)
    cj.configure_grid(x0, obj_ids=ids)
    auto_pp = cj.point_contact_capacity
    cj.point_contact_capacity = 1
    ct = collision_from_jax(cj)
    got = ct.detection_diagnostics(t(dx), t(x0), t(ids))
    assert diag_of(got) == diag_of(jax_diag(cj, dx, x0, ids))
    assert int(got["pp_dropped_pairs"]) > 0
    assert int(Collision.diag_flags(got)) & Collision.FLAG_PP_OVERFLOW
    ct.point_contact_capacity = auto_pp
    assert not bool(ct.detection_diagnostics(t(dx), t(x0),
                                             t(ids))["pp_overflow"])
    dense = Collision(dt=0.01, collision_particle_radius=0.15,
                      max_contacting_pairs=4000)
    assert pair_set(ct.detect_collisions(t(dx), t(x0), t(ids))) == pair_set(
        dense.detect_collisions(t(dx), t(x0), t(ids)))


@pytest.mark.parametrize("broad_phase", ["dense", "grid", "sweep"])
def test_cp_exclude_matches_jax(broad_phase):
    """Excluded points leave no pair and no footprint in the counts, as in
    JAX; the pair set is the full set less the excluded points' pairs."""
    dx, x0, ids = random_contact_scene(0)
    excl = np.zeros(len(x0), bool)
    excl[::3] = True
    cj = CollisionJax(dt=0.01, collision_particle_radius=0.15,
                      broad_phase=broad_phase, max_contacting_pairs=4000)
    if broad_phase == "grid":
        cj.configure_grid(x0, obj_ids=ids)
    ct = collision_from_jax(cj)
    want, dw = jax_detect(cj, dx, x0, ids, cp_exclude=excl, return_diag=True)
    got, dg = ct.detect_collisions(t(dx), t(x0), t(ids), cp_exclude=t(excl),
                                   return_diag=True)
    assert pair_set(got) == pair_set(want)
    assert diag_of(dg) == diag_of(dw)
    full = pair_set(ct.detect_collisions(t(dx), t(x0), t(ids)))
    assert pair_set(got) == {p for p in full
                             if not (excl[p[0]] or excl[p[1]])}
    assert 0 < len(pair_set(got)) < len(full)


def test_self_collision_immunity_and_unconfigured_grid():
    """One object folded onto itself: every pair immune at the default
    ratio. The grid, not configured, sets itself up from the rest points
    as the JAX package's does outside jit."""
    rng = np.random.RandomState(0)
    x0 = rng.uniform(-0.1, 0.1, (50, 3)).astype(np.float32)
    ids = np.zeros(50, np.int32)
    for bp in ("dense", "grid"):
        col = Collision(dt=0.01, collision_particle_radius=0.1,
                        broad_phase=bp, max_contacting_pairs=100)
        c = col.detect_collisions(t(np.zeros_like(x0)), t(x0), t(ids))
        assert not c.valid.any()
        if bp == "grid":
            cj = CollisionJax(dt=0.01, collision_particle_radius=0.1,
                              broad_phase="grid")
            cj.configure_grid(x0)
            assert col.grid_dims == cj.grid_dims
            assert col.point_contact_capacity == cj.point_contact_capacity


def test_compaction_is_jax_nonzero():
    """``nonzero_static`` (the compaction detection uses) is
    ``jnp.nonzero(size=…, fill_value=…)``: ascending, the first ``size``,
    padded with -1 or the value given; and ``_set_drop`` drops the indices
    past the end."""
    rng = np.random.RandomState(4)
    for p, size in ((0.3, 50), (0.05, 50), (0.0, 8), (1.0, 20)):
        mask = rng.rand(40, 7) < p
        for fill in (-1, 280):
            want = np.asarray(jnp.nonzero(jnp.asarray(mask.reshape(-1)),
                                          size=size, fill_value=fill)[0])
            kw = {} if fill == -1 else {"fill_value": fill}
            np.testing.assert_array_equal(
                nonzero_static(t(mask), size, **kw).numpy(), want)
    idx = np.array([5, 0, 9, 2, 11, 7, 3])
    vals = np.arange(7, dtype=np.float32) + 1
    want = np.asarray(jnp.zeros(8).at[idx].set(vals, unique_indices=True,
                                               mode="drop"))
    got = col_mod._set_drop(torch.zeros(8), t(idx), t(vals))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the contact terms ---------------------------------------------------

def qform_setup(seed=0, n=60, h=5):
    """``tests/physics/test_collisions.py``'s q-form scene: 60 points, 5
    handles of seeded weights, a raw-basis state z0 and step dz; JAX's
    contacts detected at z0 in both forms."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    w = rng.uniform(0.05, 1.0, (n, h)).astype(np.float32)
    ids = (np.arange(n) % 3).astype(np.int32)
    B = np.asarray(lbs_matrix_jax(jnp.asarray(x0), jnp.asarray(w)))
    z0 = (rng.randn(12 * h) * 0.02).astype(np.float32)
    dz = (rng.randn(12 * h) * 0.01).astype(np.float32)
    dz2 = (rng.randn(12 * h) * 0.2).astype(np.float32)
    dx0 = (B @ z0).reshape(-1, 3)
    dx = (B @ (z0 + dz)).reshape(-1, 3)
    cj = CollisionJax(dt=0.01, collision_particle_radius=0.08,
                      broad_phase="dense", max_contacting_pairs=2000)
    c_leg = cj.detect_collisions(jnp.asarray(dx0), jnp.asarray(x0),
                                 jnp.asarray(ids))
    c_q = cj.detect_collisions(jnp.asarray(dx0), jnp.asarray(x0),
                               jnp.asarray(ids), weights=jnp.asarray(w))
    assert int(np.sum(np.asarray(c_q.valid))) > 5
    return dict(cj=cj, ct=collision_from_jax(cj), c_leg=c_leg, c_q=c_q,
                B=B, x0=x0, w=w, ids=ids, z0=z0, dx=dx, dz=dz, dz2=dz2)


@pytest.fixture(scope="module")
def qf():
    return qform_setup()


def close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TERM_TOL * scale, (what, err, scale)


def test_contacts_cross_intact(qf):
    """``contacts_from_jax`` keeps every field: the same values, ints as
    int64, None where JAX has None."""
    for c in (qf["c_leg"], qf["c_q"]):
        p = contacts_from_jax(c)
        assert isinstance(p, Contacts)
        for name in Contacts._fields:
            a, b = getattr(c, name), getattr(p, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert p.indices_a.dtype == torch.int64


@pytest.mark.parametrize("form", ["q", "gather"])
def test_contact_terms_match_jax(qf, form):
    """energy, gradient, hessian, pullback_gradient, reduced_hessian and
    get_bounds_q on JAX's contact buffer, within 1e-5 of each output's
    largest entry."""
    cj, ct = qf["cj"], qf["ct"]
    if form == "q":
        cjx = qf["c_q"]
        kj = dict(zq=jnp.asarray(qf["dz"]))
        kt = dict(zq=t(qf["dz"]))
    else:
        cjx = qf["c_leg"]
        kj = dict(dx=jnp.asarray(qf["dx"]))
        kt = dict(dx=t(qf["dx"]))
    cpt = contacts_from_jax(cjx)
    close(ct.energy(cpt, coeff=3.0, **kt), cj.energy(cjx, coeff=3.0, **kj),
          "energy")
    g_t, g_j = ct.gradient(cpt, **kt), cj.gradient(cjx, **kj)
    close(g_t, g_j, "gradient")
    h_t, h_j = ct.hessian(cpt, **kt), cj.hessian(cjx, **kj)
    close(h_t, h_j, "hessian")
    if form == "q":
        close(ct.pullback_gradient(cpt, t(g_j)),
              cj.pullback_gradient(cjx, g_j), "pullback_gradient")
        close(ct.reduced_hessian(cpt, t(h_j)),
              cj.reduced_hessian(cjx, h_j), "reduced_hessian")
        close(ct.get_bounds_q(cpt, t(qf["dz2"]), t(qf["dz"])),
              cj.get_bounds_q(cjx, jnp.asarray(qf["dz2"]),
                              jnp.asarray(qf["dz"])), "get_bounds_q")
    else:
        _, ja, jb = cj.calculate_jacobian(cjx, jnp.asarray(qf["B"]))
        dz2x = (qf["B"] @ qf["dz2"]).reshape(-1, 3)
        close(ct.get_bounds(cpt, t(dz2x), t(qf["dx"]), t(ja), t(jb)),
              cj.get_bounds(cjx, jnp.asarray(dz2x), jnp.asarray(qf["dx"]),
                            ja, jb), "get_bounds")
        j_t = ct.calculate_jacobian(cpt, t(qf["B"]))
        j_j = cj.calculate_jacobian(cjx, jnp.asarray(qf["B"]))
        for a, b in zip(j_t, j_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_qform_matches_gather_form_and_jacobian(qf):
    """In the port alone, on its own detection: the q-form energy, gradient
    and hessian against the gather form, and its pullbacks and bounds
    against the explicit jacobian (the JAX file's tolerances: the log
    barrier's second derivatives amplify float32 noise in the offsets)."""
    ct = qf["ct"]
    x0, w, ids = t(qf["x0"]), t(qf["w"]), t(qf["ids"])
    B = lbs_matrix(x0, w)
    z0, dz, dz2 = t(qf["z0"]), t(qf["dz"]), t(qf["dz2"])
    dx0 = (B @ z0).reshape(-1, 3)
    dx = (B @ (z0 + dz)).reshape(-1, 3)
    c_leg = ct.detect_collisions(dx0, x0, ids)
    c_q = ct.detect_collisions(dx0, x0, ids, weights=w)
    assert torch.equal(c_leg.indices_a, c_q.indices_a)
    assert int(c_q.valid.sum()) > 5
    np.testing.assert_allclose(ct.energy(c_q, zq=dz).numpy(),
                               ct.energy(c_leg, dx=dx).numpy(),
                               rtol=1e-5, atol=1e-6)
    g_leg = ct.gradient(c_leg, dx=dx)
    np.testing.assert_allclose(ct.gradient(c_q, zq=dz).numpy(),
                               g_leg.numpy(), rtol=1e-4, atol=1e-6)
    h_leg = ct.hessian(c_leg, dx=dx)
    np.testing.assert_allclose(ct.hessian(c_q, zq=dz).numpy(),
                               h_leg.numpy(), rtol=2e-3, atol=1e-2)
    cJ, cJa, cJb = ct.calculate_jacobian(c_leg, B)
    np.testing.assert_allclose(
        ct.pullback_gradient(c_q, ct.gradient(c_q, zq=dz)).numpy(),
        (cJ.T @ g_leg.reshape(-1)).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ct.reduced_hessian(c_q, ct.hessian(c_q, zq=dz)).numpy(),
        hess_reduction(cJ, h_leg).numpy(), rtol=2e-3, atol=5e-2)
    np.testing.assert_allclose(
        ct.get_bounds_q(c_q, dz2, dz).numpy(),
        ct.get_bounds(c_leg, (B @ dz2).reshape(-1, 3), dx, cJa,
                      cJb).numpy(), rtol=1e-5, atol=1e-6)
