"""kaolin_tpu_torch's FlexiCubes (``ops/conversions/flexicubes``: the
tables, ``dense_extract``, ``FlexiCubes`` with its topology, ``__call__``,
the tet mesh, the QEF path and ``jit_extract``) against kaolin_tpu's, on
the CPU at res 12, mirroring ``tests/ops/test_flexicubes_{dense,static,
tetmesh}.py`` and ``test_conversions.py::TestFlexiCubes``.

The same numpy fields and weights go to both packages: a sphere, the
ellipsoid that config 4 starts from, a bumpy sphere and a seeded random
field that hits the C16/C19 ambiguity cases. Integers (the topology
arrays, case ids, faces, tets, masks, counts) are equal; floats within
1e-6 absolute (the dense path's ``x * h + origin`` is one rounding apart
where XLA contracts it into a fused multiply-add); gradients within 1e-5
of their largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.non_commercial as nc_jax
from kaolin_tpu.ops.conversions import FlexiCubes as JaxFlexiCubes
from kaolin_tpu.ops.conversions import dense_extract as jax_dense
from kaolin_tpu.ops.conversions import _mc_tables as mc_jax
from kaolin_tpu.ops.conversions.flexicubes import _tables as tables_jax
from kaolin_tpu_torch import non_commercial
from kaolin_tpu_torch.ops.conversions import FlexiCubes, dense_extract
from kaolin_tpu_torch.ops.conversions import _mc_tables as mc_port
from kaolin_tpu_torch.ops.conversions.flexicubes import _tables as tables_port
from tests.torch_parity import warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

RES = 12
ATOL, GRAD_TOL = 1e-6, 1e-5
FIELDS = ("sphere", "ellipsoid", "bumpy", "random")


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def eq(port, want):
    np.testing.assert_array_equal(torch.as_tensor(port).detach().numpy(),
                                  np.asarray(want))


def close(port, want, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def grad_close(port_grad, want_grad):
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(port_grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


def make_field(name, v):
    """A (V,) float32 field on the grid vertices ``v`` (numpy)."""
    rng = np.random.RandomState(0)
    if name == "sphere":
        f = np.linalg.norm(v, axis=-1) - 0.35
    elif name == "ellipsoid":
        f = np.linalg.norm(v * [1.6, 0.7, 1.0], axis=-1) - 0.35
    elif name == "bumpy":
        f = (np.linalg.norm(v, axis=-1) - 0.3
             + 0.08 * np.sin(7 * v[:, 0]) * np.cos(5 * v[:, 1])
             + 0.02 * rng.randn(v.shape[0]))
    else:
        f = rng.randn(v.shape[0]) * 0.1
    return f.astype(np.float32)


def weights(n, seed=1, scale=0.5):
    rng = np.random.RandomState(seed)
    return {"beta": (rng.randn(n, 12) * scale).astype(np.float32),
            "alpha": (rng.randn(n, 8) * scale).astype(np.float32),
            "gamma_f": rng.randn(n).astype(np.float32)}


def jax_call(grid, sdf, **kw):
    """kaolin_tpu's ``FlexiCubes.__call__`` on a numpy field, its topology
    found on the host and the geometry jitted (as the JAX package's own
    loops run it)."""
    jfc = grid["jfc"]
    topo = jfc.precompute_topology(sdf, grid["jc"], RES)
    if kw.get("output_tetmesh"):
        kw["tet_topology"] = jfc.precompute_tet_topology(
            sdf, grid["jc"], topo, training=kw.get("training", False))
    arrays = {k: kw.pop(k) for k in ("beta", "alpha", "gamma_f",
                                     "voxelgrid_features") if k in kw}

    def fn(v, s, arrays):
        return jfc(v, s, grid["jc"], RES, topology=topo, **arrays, **kw)
    return jax.jit(fn)(grid["jv"], jnp.asarray(sdf),
                       {k: jnp.asarray(x) for k, x in arrays.items()})


@functools.lru_cache(maxsize=None)
def jax_dense_fn(training):
    """kaolin_tpu's ``dense_extract`` at RES, jitted once a mode (the
    fields share their shapes)."""
    return jax.jit(lambda s, kw: jax_dense(s, RES, training=training, **kw))


@functools.lru_cache(maxsize=None)
def jax_grid():
    jfc = JaxFlexiCubes()
    return (jfc,) + tuple(jfc.construct_voxel_grid(RES))


@functools.lru_cache(maxsize=None)
def jax_static_fn(training):
    """kaolin_tpu's ``jit_extract`` at RES, jitted once a mode."""
    jfc, jv, jc = jax_grid()
    return jax.jit(lambda s, kw: jfc.jit_extract(jv, s, jc, RES,
                                                 training=training, **kw))


@pytest.fixture(scope="module")
def grid():
    jfc, jv, jc = jax_grid()
    fc = FlexiCubes(device="cpu")
    v, c = fc.construct_voxel_grid(RES)
    return {"jfc": jfc, "jv": jv, "jc": jc, "fc": fc, "v": v, "c": c,
            "fields": {n: make_field(n, np.asarray(jv)) for n in FIELDS}}


def test_tables_are_jax_copies():
    for name in ("DMC_TABLE", "NUM_VD_TABLE", "CHECK_TABLE", "TET_TABLE"):
        eq(getattr(tables_port, name), getattr(tables_jax, name))
    for name in ("MC_EDGE_TABLE", "MC_TRI_TABLE"):
        eq(getattr(mc_port, name), getattr(mc_jax, name))


def test_construct_voxel_grid(grid):
    """Bit for bit: the float64 grid rounded once after the shift."""
    eq(grid["v"], grid["jv"])
    eq(grid["c"], grid["jc"])
    assert grid["v"].dtype == torch.float32 and grid["c"].dtype == torch.long
    v, c = FlexiCubes(device="cpu").construct_voxel_grid((3, 4, 5))
    jv, jc = JaxFlexiCubes().construct_voxel_grid((3, 4, 5))
    eq(v, jv)
    eq(c, jc)


def test_flexicubes_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlexiCubes()
    assert non_commercial.FlexiCubes is FlexiCubes
    assert nc_jax.FlexiCubes is JaxFlexiCubes


@pytest.mark.parametrize("field", FIELDS)
def test_topology_matches_jax(grid, field):
    """Every array of the topology equal, in JAX's order (``np.unique``
    rows, the stable quad sort, the dual vertices by num_vd)."""
    sdf = grid["fields"][field]
    want = grid["jfc"].precompute_topology(sdf, grid["jc"], RES)
    got = grid["fc"].precompute_topology(t(sdf), grid["c"], RES)
    for name in want._fields:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
        elif isinstance(w, int):
            assert getattr(got, name) == w
        else:
            eq(getattr(got, name), w)
    tet_want = grid["jfc"].precompute_tet_topology(sdf, grid["jc"], want)
    tet_got = grid["fc"].precompute_tet_topology(t(sdf), grid["c"], got)
    for name in tet_want._fields:
        eq(getattr(tet_got, name), getattr(tet_want, name))


def test_random_field_resolves_ambiguities(grid):
    """The random field holds C16/C19 cubes that invert: the resolved case
    ids differ from the raw corner codes, the same cubes in both
    packages."""
    sdf = grid["fields"]["random"]
    topo = grid["fc"].precompute_topology(t(sdf), grid["c"], RES)
    occ = t(sdf)[grid["c"]][topo.surf_cubes] < 0
    raw = (occ.long() * 2 ** torch.arange(8)).sum(-1)
    assert int((raw != topo.case_ids).sum()) > 0
    surf = topo.surf_cubes.view(RES, RES, RES)
    case = torch.zeros(RES ** 3, dtype=torch.long)
    case[topo.surf_cubes.view(-1)] = raw
    resolved = grid["fc"]._resolve_ambiguities_device(case, surf.view(-1),
                                                      RES)
    eq(resolved[topo.surf_cubes], topo.case_ids)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("field", FIELDS)
def test_call_matches_jax(grid, field, training):
    sdf = grid["fields"][field]
    want = jax_call(grid, sdf, training=training)
    got = grid["fc"](grid["v"], t(sdf), grid["c"], RES, training=training)
    close(got[0], want[0])
    eq(got[1], want[1])
    close(got[2], want[2])


@pytest.mark.parametrize("training", [False, True])
def test_call_with_weights_and_features(grid, training):
    sdf = grid["fields"]["bumpy"]
    w = weights(RES ** 3)
    feats = np.random.RandomState(2).rand(
        (RES + 1) ** 3, 5).astype(np.float32)
    want = jax_call(grid, sdf, training=training, voxelgrid_features=feats,
                    **w)
    got = grid["fc"](grid["v"], t(sdf), grid["c"], RES, training=training,
                     voxelgrid_features=t(feats),
                     **{k: t(x) for k, x in w.items()})
    close(got[0], want[0])
    eq(got[1], want[1])
    close(got[2], want[2])
    close(got[3], want[3])


def test_call_gradients_match_jax(grid):
    """d(sum v² + sum l_dev)/d(sdf, beta, alpha, gamma_f) with a fixed
    topology, training split. JAX's gradient is compiled without XLA's
    optimizations, which gives the arithmetic of the eager run that
    ``examples/flexicubes_sdf.py`` makes: optimized, XLA contracts the quad
    centres' products into fused multiply-adds, and gamma's gradient, a
    difference of nearby vertices, moves by 1.5e-5 of its largest entry."""
    sdf = grid["fields"]["ellipsoid"]
    w = weights(RES ** 3, scale=0.2)
    topo_j = grid["jfc"].precompute_topology(sdf, grid["jc"], RES)
    topo_t = grid["fc"].precompute_topology(t(sdf), grid["c"], RES)

    def jax_loss(s, beta, alpha, gamma_f):
        v, _, l_dev = grid["jfc"](grid["jv"], s, grid["jc"], RES,
                                  topology=topo_j, training=True, beta=beta,
                                  alpha=alpha, gamma_f=gamma_f)
        return jnp.sum(v ** 2) + jnp.sum(l_dev)

    optimized = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(
            jnp.asarray(sdf), *(jnp.asarray(w[k])
                                for k in ("beta", "alpha", "gamma_f")))
    finally:
        jax.config.update("jax_disable_most_optimizations", optimized)
    args = [t(sdf).requires_grad_(True)] + [
        t(w[k]).requires_grad_(True) for k in ("beta", "alpha", "gamma_f")]
    v, _, l_dev = grid["fc"](grid["v"], args[0], grid["c"], RES,
                             topology=topo_t, training=True, beta=args[1],
                             alpha=args[2], gamma_f=args[3])
    ((v ** 2).sum() + l_dev.sum()).backward()
    for a, g in zip(args, want):
        assert np.abs(np.asarray(g)).max() > 0
        grad_close(a.grad, g)


def qef_reference(topo, grid_v, cube_idx, sdf, normal, reg=1e-3):
    """Each dual vertex's QEF solution in float64 numpy, one
    ``np.linalg.lstsq`` a vertex, from JAX's topology: the system that
    kaolin_tpu's ``_solve_qef`` builds."""
    v = np.asarray(grid_v, np.float64)
    e = topo.surf_edges
    s0, s1 = sdf[e[:, 0]].astype(np.float64), sdf[e[:, 1]].astype(np.float64)
    zc = (v[e[:, 0]] * s1[:, None] - v[e[:, 1]] * s0[:, None]) \
        / (s1 - s0)[:, None]
    nrm = normal(zc)
    idx = topo.idx_map.reshape(-1)[topo.edge_group_to_cube * 12
                                   + topo.edge_group]
    surf_rows = np.asarray(cube_idx)[topo.surf_cubes]
    out = np.zeros((topo.total_num_vd, 3))
    for vd in range(topo.total_num_vd):
        sel = topo.edge_group_to_vd == vd
        p, n = zc[idx[sel]], nrm[idx[sel]]
        v0 = v[surf_rows[topo.edge_group_to_cube[sel][0], 0]]
        a = np.concatenate([n, np.eye(3) * reg])
        b = np.concatenate([((p - v0) * n).sum(-1),
                            reg * (p.mean(0) - v0)])
        out[vd] = np.linalg.lstsq(a, b, rcond=None)[0] + v0
    return out


def test_qef_placement(grid):
    """``grad_func`` (the sphere's normal) selects the QEF placement and
    the normals' quad split; l_dev is 0. kaolin_tpu's QEF path raises
    (fault F22: ``jnp.linalg.lstsq`` takes no batch), so the port's
    vertices are held within 1e-5 of a float64 numpy solve of the same
    systems, and its faces follow the split rule on its own vertices."""
    sdf = grid["fields"]["sphere"]

    def jgrad(x):
        return x / jnp.linalg.norm(x, axis=-1, keepdims=True)

    with pytest.raises(TypeError, match="two-dimensional"):
        jax_call(grid, sdf, grad_func=jgrad)
    topo = grid["jfc"].precompute_topology(sdf, grid["jc"], RES)
    want = qef_reference(topo, grid["jv"], grid["jc"], sdf,
                         lambda x: x / np.linalg.norm(x, axis=-1,
                                                      keepdims=True))
    def tgrad(x):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True)

    for training in (False, True):
        v, f, l_dev = grid["fc"](grid["v"], t(sdf), grid["c"], RES,
                                 training=training, grad_func=tgrad)
        close(v[:topo.total_num_vd], want, atol=1e-5)
        eq(l_dev, [0.0])
        n = tgrad(v[:topo.total_num_vd])
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
        q = t(topo.quad_vd_idx)
        g02 = (n[q[:, 0]] * n[q[:, 2]]).sum(-1)
        g13 = (n[q[:, 1]] * n[q[:, 3]]).sum(-1)
        if training:
            assert f.shape == (4 * q.shape[0], 3)
            eq(f.reshape(-1, 4, 3)[:, :, :2].reshape(-1, 8),
               q[:, [0, 1, 1, 2, 2, 3, 3, 0]])
        else:
            split = torch.where((g02 > g13)[:, None],
                                q[:, [0, 1, 2, 0, 2, 3]],
                                q[:, [0, 1, 3, 3, 1, 2]])
            eq(f, split.reshape(-1, 3))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("field", ("sphere", "random"))
def test_tetmesh_matches_jax(grid, field, training):
    sdf = grid["fields"][field]
    want = jax_call(grid, sdf, output_tetmesh=True, training=training)
    got = grid["fc"](grid["v"], t(sdf), grid["c"], RES, output_tetmesh=True,
                     training=training)
    close(got[0], want[0])
    eq(got[1], want[1])
    close(got[2], want[2])


def test_tetmesh_partitions_enclosed_volume(grid):
    """The tets tile the surface mesh's inside: their signed volumes sum to
    the mesh's volume (``test_flexicubes_tetmesh.py``'s invariant)."""
    sdf = t(grid["fields"]["sphere"])
    v, tets, _ = grid["fc"](grid["v"], sdf, grid["c"], RES,
                            output_tetmesh=True)
    tv = v.double()[tets]
    vol = torch.linalg.det(tv[:, 1:] - tv[:, :1]) / 6.0
    assert bool((vol.abs() > 1e-12).all())
    v2, faces, _ = grid["fc"](grid["v"], sdf, grid["c"], RES)
    mesh_vol = abs(float(torch.linalg.det(v2.double()[faces]).sum()) / 6.0)
    np.testing.assert_allclose(abs(float(vol.sum())), mesh_vol, rtol=1e-5)


def test_empty_surface(grid):
    sdf = torch.ones((RES + 1) ** 3)
    assert grid["fc"].precompute_topology(sdf, grid["c"], RES) is None
    v, f, l_dev = grid["fc"](grid["v"], sdf, grid["c"], RES)
    assert v.shape == (0, 3) and f.shape == (0, 3) and l_dev.shape == (0,)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("field", FIELDS)
def test_jit_extract_matches_jax(grid, field, training):
    """Fixed shapes, every slot (padding included) equal: vertices, faces,
    l_dev, masks, counts and capacities."""
    sdf = grid["fields"][field]
    kw = {} if field != "bumpy" else weights(RES ** 3)
    want = jax_static_fn(training)(
        jnp.asarray(sdf), {k: jnp.asarray(x) for k, x in kw.items()})
    got = grid["fc"].jit_extract(grid["v"], t(sdf), grid["c"], RES,
                                 training=training,
                                 **{k: t(x) for k, x in kw.items()})
    close(got[0], want[0])
    eq(got[1], want[1])
    close(got[2], want[2])
    for k in ("face_mask", "vertex_mask"):
        eq(got[3][k], want[3][k])
    for k in ("surf_cubes", "quads"):
        assert int(got[3]["counts"][k]) == int(want[3]["counts"][k])
    assert got[3]["capacities"] == want[3]["capacities"]


def test_jit_extract_reports_overflow(grid):
    """Capacities below the counts: the outputs are cut at them, and the
    counts say so, as in JAX."""
    sdf = grid["fields"]["random"]
    caps = {"cubes": 256, "quads": 128}
    want = jax.jit(lambda s: grid["jfc"].jit_extract(
        grid["jv"], s, grid["jc"], RES, capacities=caps))(jnp.asarray(sdf))
    got = grid["fc"].jit_extract(grid["v"], t(sdf), grid["c"], RES,
                                 capacities=caps)
    assert int(got[3]["counts"]["surf_cubes"]) > 256
    assert int(got[3]["counts"]["quads"]) > 128
    close(got[0], want[0])
    eq(got[1], want[1])
    for k in ("surf_cubes", "quads"):
        assert int(got[3]["counts"][k]) == int(want[3]["counts"][k])
    sdf_e = grid["fields"]["ellipsoid"]
    assert FlexiCubes.suggest_capacities(t(sdf_e), grid["c"]) == \
        JaxFlexiCubes.suggest_capacities(sdf_e, grid["jc"])
    assert FlexiCubes.static_capacities((12, 20, 8)) == \
        JaxFlexiCubes.static_capacities((12, 20, 8))


def test_jit_extract_gradients_match_jax(grid):
    sdf = grid["fields"]["sphere"]

    def jax_loss(s):
        v, f, _, aux = grid["jfc"].jit_extract(grid["jv"], s, grid["jc"],
                                               RES, training=True)
        cent = jnp.mean(v[f], axis=1)
        return jnp.sum(jnp.where(aux["face_mask"], jnp.sum(cent ** 2, -1),
                                 0.0))

    want = jax.jit(jax.grad(jax_loss))(jnp.asarray(sdf))
    s = t(sdf).requires_grad_(True)
    v, f, _, aux = grid["fc"].jit_extract(grid["v"], s, grid["c"], RES,
                                          training=True)
    cent = v[f].mean(dim=1)
    torch.where(aux["face_mask"], (cent ** 2).sum(-1), 0.0).sum().backward()
    grad_close(s.grad, want)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("field", FIELDS)
def test_dense_matches_jax(grid, field, training):
    sdf = grid["fields"][field]
    kw = {} if field != "bumpy" else weights(RES ** 3)
    want = jax_dense_fn(training)(
        jnp.asarray(sdf), {k: jnp.asarray(x) for k, x in kw.items()})
    got = dense_extract(t(sdf), RES, training=training,
                        **{k: t(x) for k, x in kw.items()})
    close(got[0], want[0])
    eq(got[1], want[1])
    close(got[2], want[2])
    for k in ("face_mask", "vertex_mask", "vd_valid_dense"):
        eq(got[3][k], want[3][k])
    close(got[3]["vd_dense"], want[3]["vd_dense"])
    for k in ("surf_cubes", "quads"):
        assert int(got[3]["counts"][k]) == int(want[3]["counts"][k])


def test_dense_stages_match_jax(grid):
    """The ``_stage`` prefixes give JAX's scalars."""
    sdf = grid["fields"]["bumpy"]
    for stage in ("case", "m", "zc", "vd", "ldev"):
        want = float(jax.jit(lambda s: jax_dense(s, RES, _stage=stage))(
            jnp.asarray(sdf)))
        got = float(dense_extract(t(sdf), RES, _stage=stage))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dense_gradients_match_jax(grid):
    """The bench's loss on the dense views, differentiated in the field
    and the three weights."""
    sdf = grid["fields"]["ellipsoid"]
    w = weights(RES ** 3, scale=0.2)
    names = ("beta", "alpha", "gamma_f")

    def jax_loss(s, beta, alpha, gamma_f):
        _, _, reg, aux = jax_dense(s, RES, beta=beta, alpha=alpha,
                                   gamma_f=gamma_f, training=True)
        vd, vm = aux["vd_dense"], aux["vd_valid_dense"]
        d = jnp.abs(jnp.sqrt(jnp.sum(vd * vd, axis=1)) - 0.35) * vm
        nv = jnp.clip(jnp.sum(vm), 1, None)
        return jnp.sum(d) / nv + 0.01 * jnp.sum(reg) / nv

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(sdf), *(jnp.asarray(w[k]) for k in names))
    args = [t(sdf).requires_grad_(True)] + [
        t(w[k]).requires_grad_(True) for k in names]
    _, _, reg, aux = dense_extract(args[0], RES, training=True,
                                   **dict(zip(names, args[1:])))
    vd, vm = aux["vd_dense"], aux["vd_valid_dense"]
    d = (torch.sqrt((vd * vd).sum(dim=1)) - 0.35).abs() * vm
    nv = vm.sum().clamp(min=1)
    (d.sum() / nv + 0.01 * reg.sum() / nv).backward()
    # gamma_f moves only the quad centres, which this loss does not read
    assert args[3].grad is None and not np.asarray(want[3]).any()
    for a, g in zip(args[:3], want[:3]):
        assert np.isfinite(a.grad.numpy()).all()
        grad_close(a.grad, g)
