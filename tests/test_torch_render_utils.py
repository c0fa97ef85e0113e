"""The port's ``render/mesh/utils.py`` (``texture_mapping``,
``spherical_harmonic_lighting``, ``prepare_vertices``) and the JAX
rasterizer's capacity API (``suggest_tile_cap``, ``tile_overflow_report``)
against kaolin_tpu's, on the CPU; and two of the repo's golden images
rendered by the port. The texture kernels' wrappers (``cuda_texture``):
their argument checks, their launch counters, and ``texture_mapping``'s
reading of a texture expanded to every view as the one texture.

The same seeded numpy inputs go to both packages. Texture values agree
within 1e-6 (the sampling takes JAX's gathers and weights in its order),
their gradients within 1e-5; ``prepare_vertices`` as its test says;
capacities, counts and flags exactly. The goldens are held at
the thresholds of ``tests/render/test_golden_corpus.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render.mesh import rasterization as jrast
from kaolin_tpu.render.mesh import utils as jutils
from kaolin_tpu.utils.testing import assert_images_close
from kaolin_tpu_torch.ops.mesh import face_normals, index_vertices_by_faces
from kaolin_tpu_torch.render import mesh as tmesh
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.mesh import cuda_texture
from kaolin_tpu_torch.render.mesh import rasterization as trast
from kaolin_tpu_torch.render.mesh import utils as tutils
from kaolin_tpu_torch.utils import profiling
from kaolin_tpu_torch.utils.numerics import clip
from tests.render.golden_corpus import GOLDEN_DIR
from tests.torch_parity import load_example, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

ATOL, GRAD_TOL = 1e-6, 1e-5
RNG = np.random.RandomState(0)
TEX = RNG.rand(2, 3, 9, 7).astype(np.float32)


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def uv_cases():
    """(B, H, W, 2) UVs: random ones, ones outside [0, 1], and exactly 0
    and 1 in u and in v; and texel centres, where a nearest sample rounds
    half to even."""
    uv = RNG.uniform(-0.2, 1.2, (2, 4, 5, 2)).astype(np.float32)
    uv[:, 0, :, 0] = 0.0
    uv[:, 1, :, 0] = 1.0
    uv[:, 2, :, 1] = 0.0
    uv[:, 3, :, 1] = 1.0
    half = ((np.arange(5) + 0.5) / 7).astype(np.float32)
    uv[1, 0, :, 1] = half
    return uv


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("flat", [False, True])
def test_texture_mapping_values_and_gradients(mode, flat):
    """Values, the gradient with respect to the texture and (bilinear) the
    UVs, with UVs outside [0, 1] and exactly on 0 and 1."""
    uv = uv_cases()
    if flat:
        uv = uv.reshape(2, -1, 2)
    w = RNG.randn(*uv.shape[:-1], 3).astype(np.float32)

    def loss_j(u, t):
        return jnp.sum(jnp.asarray(w) * jutils.texture_mapping(u, t, mode))

    want = jax.jit(jutils.texture_mapping, static_argnums=2)(
        jnp.asarray(uv), jnp.asarray(TEX), mode)
    gu_j, gt_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(uv),
                                                           jnp.asarray(TEX))
    u_t = torch.tensor(uv, requires_grad=True)
    t_t = torch.tensor(TEX, requires_grad=True)
    got = tutils.texture_mapping(u_t, t_t, mode)
    assert got.shape == want.shape
    close(got, want)
    (torch.from_numpy(w) * got).sum().backward()
    close(t_t.grad, gt_j, atol=GRAD_TOL)
    if mode == "nearest":      # the UVs only choose texels: no gradient
        assert u_t.grad is None and not np.asarray(gu_j).any()
    else:
        close(u_t.grad, gu_j, atol=GRAD_TOL)


def test_uv_clip_splits_the_gradient_at_0_and_1_as_jax():
    """``jnp.clip``'s gradient at a bound is half the interior one;
    ``torch.clamp`` gives all of it. The port's ``clip`` (the UV clip of
    ``texture_mapping``) gives JAX's. Under border padding a sample's
    derivative at exactly 0 or 1 is itself 0 (both neighbours clip to one
    texel), so there ``texture_mapping``'s UV gradient is 0 in both
    packages; inside it equals JAX's and is not 0."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * 3.0))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (clip(xt, 0.0, 1.0) * 3.0).sum().backward()
    close(xt.grad, want, atol=0)
    np.testing.assert_array_equal(np.asarray(want), [0, 1.5, 3, 1.5, 0])

    uv = np.array([[[0.0, 0.4], [1.0, 0.4], [0.4, 0.0], [0.4, 1.0],
                    [0.3, 0.45], [0.62, 0.7]]], np.float32)
    g_j = jax.jit(jax.grad(lambda u: jnp.sum(jutils.texture_mapping(
        u, jnp.asarray(TEX[:1]), "bilinear"))))(jnp.asarray(uv))
    ut = torch.tensor(uv, requires_grad=True)
    tutils.texture_mapping(ut, torch.from_numpy(TEX[:1]),
                           "bilinear").sum().backward()
    close(ut.grad, g_j, atol=GRAD_TOL)
    assert np.all(ut.grad.numpy()[0, :4][[0, 1, 2, 3], [0, 0, 1, 1]] == 0)
    assert np.all(ut.grad.numpy()[0, 4:] != 0)


def _bad_texture_inputs():
    """(label, uv, texture, mode, error) that the texture kernels' checks
    refuse: each with one thing wrong, on the CPU."""
    uv = torch.rand(2, 6, 2)
    tex = torch.rand(1, 3, 4, 5)
    return [
        ("uv float64", uv.double(), tex, "bilinear", TypeError),
        ("texture int32", uv, tex.int(), "bilinear", TypeError),
        ("uv (2, 6, 3)", torch.rand(2, 6, 3), tex, "bilinear", ValueError),
        ("uv (2, 12)", uv.reshape(2, 12), tex, "bilinear", ValueError),
        ("texture (3, 4, 5)", uv, tex[0], "bilinear", ValueError),
        ("texture batch 3", uv, tex.expand(3, -1, -1, -1), "bilinear",
         ValueError),
        ("mode", uv, tex, "bicubic", ValueError),
        ("uv on the CPU", uv, tex, "bilinear", ValueError),
        ("uv on the CPU, nearest", uv, tex, "nearest", ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_bad_texture_inputs())))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_texture_kernel_checks_raise(case, direction):
    """The wrappers refuse a wrong dtype, shape, mode or device before any
    launch, forward and backward, on any device: the checks of type and
    shape come before the device's."""
    label, uv, tex, mode, error = _bad_texture_inputs()[case]
    with pytest.raises(error):
        if direction == "forward":
            cuda_texture.texture_fwd_cuda(uv, tex, mode)
        else:
            grad = torch.zeros(uv.shape[0], uv.shape[1], tex.shape[1])
            cuda_texture.texture_bwd_cuda(uv, tex, grad, mode)


def test_texture_kernel_launch_counters_listed():
    """Both launch counters are in the registry from the wrapper's import,
    at 0 where no card ran them, also after a CPU call and its backward
    (the plain version)."""
    got = profiling.counters()
    assert got[cuda_texture.FWD_LAUNCHES] == 0
    assert got[cuda_texture.BWD_LAUNCHES] == 0
    tutils.texture_mapping(torch.rand(2, 4, 2, requires_grad=True),
                           torch.rand(2, 3, 4, 4), "bilinear").sum().backward()
    got = profiling.counters()
    assert got[cuda_texture.FWD_LAUNCHES] == got[cuda_texture.BWD_LAUNCHES] \
        == 0


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("views", [1, 3])
def test_one_texture_expanded_to_every_view(mode, views):
    """A texture expanded to every view (batch stride 0) is read as the
    tensor it was expanded from: values, the UV gradient and the texture's
    gradient equal the plain version's on the expanded batch (whose
    gradient ``expand``'s backward sums over the views), and the gradient
    reaches the texture through no ``ExpandBackward0`` of the caller's.
    Per-view textures, a batch of one, and an expand of a texture that is
    not contiguous are read as given."""
    uv = uv_cases().reshape(2, -1, 2)
    uv = np.concatenate([uv] * 2)[:views]
    w = torch.from_numpy(RNG.randn(*uv.shape[:-1], 3).astype(np.float32))
    got, want = {}, {}
    for out, route in ((got, True), (want, False)):
        u = torch.tensor(uv, requires_grad=True)
        t = torch.tensor(TEX[0], requires_grad=True)
        batch = t[None].expand(views, -1, -1, -1)
        if route:
            val = tutils.texture_mapping(u, batch, mode)
            reached = batch.grad_fn in _nodes(val.grad_fn)
        else:
            val = tutils.texture_mapping_plain(u, batch, mode)
        (w * val).sum().backward()
        out.update(val=val.detach(), gt=t.grad,
                   gu=u.grad if u.grad is not None else torch.zeros(1))
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert reached == (views == 1)
    assert tutils._one_texture(batch) is (t if views > 1 else None)
    per_view = torch.from_numpy(TEX)
    assert tutils._one_texture(per_view) is None
    strided = torch.from_numpy(TEX[0]).transpose(1, 2)[None].expand(2, -1,
                                                                    -1, -1)
    assert tutils._one_texture(strided) is None


def _expanded(case, views=3):
    """A leaf texture (3, H', W') and a batch of ``views`` read from it
    with stride 0, made as ``case`` names → (leaf, batch)."""
    if case == "dtype view":    # float32 over the bits of an int32 tensor
        bits = torch.from_numpy(TEX[0].view(np.int32).copy())
        t = bits.view(torch.float32)
        return t, t[None].expand(views, -1, -1, -1)
    t = torch.tensor(TEX[0], requires_grad=True)
    if case == "no_grad":
        with torch.no_grad():
            batch = t[None].expand(views, -1, -1, -1)
    elif case == "detached, then made to require grad":
        batch = t.detach()[None].expand(views, -1, -1, -1).requires_grad_()
    else:   # "detached after the expand"
        batch = t[None].expand(views, -1, -1, -1).detach()
    return t, batch


@pytest.mark.parametrize("case", ["no_grad",
                                  "detached, then made to require grad",
                                  "detached after the expand", "dtype view"])
def test_one_texture_refusals(case):
    """A stride-0 batch whose gradient would not reach the tensor it was
    expanded from through its own backward (made under ``no_grad``, or
    detached from it) is not read as that tensor; a base is only ever
    taken in the batch's dtype. In each case ``texture_mapping`` gives the
    plain version's values and gradients on the batch as given, and a
    gradient reaches the leaf and the batch exactly where it does there."""
    t, batch = _expanded(case)
    base = tutils._one_texture(batch)
    if case == "dtype view":
        assert base is None or base.dtype == batch.dtype
    else:
        assert base is None
    uv = torch.from_numpy(uv_cases().reshape(1, -1, 2))
    w = torch.from_numpy(RNG.randn(3, uv.shape[1], 3).astype(np.float32))
    got, want = {}, {}
    for out, fn in ((got, tutils.texture_mapping),
                    (want, tutils.texture_mapping_plain)):
        t, batch = _expanded(case)
        u = uv.expand(3, -1, -1).clone().requires_grad_(True)
        val = fn(u, batch, "bilinear")
        (w * val).sum().backward()
        out.update(val=val.detach(), gu=u.grad, gt=t.grad, gb=batch.grad)
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_texture_mapping_backward_once_differentiable():
    """The kernels' backward gives gradients with no graph: a second
    derivative through ``_TextureMapping`` raises instead of coming out
    as missing or zero. Run through the autograd Function itself, with a
    stand-in for the card's kernels (their output is what the wrappers
    return: plain tensors made outside autograd)."""
    uv = torch.rand(2, 5, 2, requires_grad=True)
    tex = torch.rand(1, 3, 4, 4, requires_grad=True)
    fwd, bwd = cuda_texture.texture_fwd_cuda, cuda_texture.texture_bwd_cuda

    def plain_fwd(u, t, mode):
        with torch.no_grad():
            return tutils.texture_mapping_plain(u, t, mode)

    def plain_bwd(u, t, g, mode, need_uv=True, need_texture=True):
        with torch.enable_grad():
            u, t = u.detach().requires_grad_(), t.detach().requires_grad_()
            out = tutils.texture_mapping_plain(u, t, mode)
            return torch.autograd.grad(out, (u, t), g)

    cuda_texture.texture_fwd_cuda = plain_fwd
    cuda_texture.texture_bwd_cuda = plain_bwd
    try:
        out = tutils._TextureMapping.apply(uv, tex, "bilinear")
        gu, gt = torch.autograd.grad(out.square().sum(), (uv, tex),
                                     create_graph=True)
        want = torch.autograd.grad(
            tutils.texture_mapping_plain(uv, tex, "bilinear").square().sum(),
            (uv, tex))
        torch.testing.assert_close(gt, want[1], rtol=1e-6, atol=1e-6)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            gu.sum().backward()
    finally:
        cuda_texture.texture_fwd_cuda = fwd
        cuda_texture.texture_bwd_cuda = bwd


def _nodes(root):
    seen, todo = {root}, [root]
    while todo:
        node = todo.pop()
        for nxt, _ in node.next_functions:
            if nxt is not None and nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return seen


def test_spherical_harmonic_lighting():
    n = RNG.randn(2, 4, 5, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lights = RNG.randn(2, 9).astype(np.float32)
    close(tutils.spherical_harmonic_lighting(torch.from_numpy(n),
                                             torch.from_numpy(lights)),
          jutils.spherical_harmonic_lighting(jnp.asarray(n),
                                             jnp.asarray(lights)))


def _prepare_case():
    v, f = load_example().uv_sphere(6, 8)
    verts = (v[None] * np.float32(0.8)
             + RNG.uniform(-0.05, 0.05, (2,) + v.shape)).astype(np.float32)
    return verts, f.astype(np.int64)


@pytest.mark.parametrize("branch", ["transform", "rot_trans"])
def test_prepare_vertices(branch):
    """Both camera branches: the (B, 4, 3) transform of
    ``generate_transformation_matrix`` and (rot, trans) of
    ``generate_rotate_translate_matrices``. Values within 5e-5 (the unit
    normals of the sphere's small polar faces divide rounding of the two
    packages' other matmul orders by short cross products) and the gradient
    of a weighted sum of all three outputs with respect to the vertices
    within 1e-4 of its largest entry."""
    from kaolin_tpu.render.camera import legacy as jleg
    from kaolin_tpu_torch.render.camera import legacy as tleg

    verts, faces = _prepare_case()
    pos = np.array([[0.5, 1.0, 3.0], [-2.5, 0.5, 1.5]], np.float32)
    look = np.zeros((2, 3), np.float32)
    up = np.array([[0.0, 1.0, 0.0]], np.float32)
    proj_j = jleg.generate_perspective_projection(np.pi / 3)
    proj_t = tleg.generate_perspective_projection(np.pi / 3, device="cpu")
    if branch == "transform":
        cj = {"camera_transform": jleg.generate_transformation_matrix(
            jnp.asarray(pos), jnp.asarray(look), jnp.asarray(up))}
        ct = {"camera_transform": tleg.generate_transformation_matrix(
            *(torch.from_numpy(x) for x in (pos, look, up)))}
    else:
        r, t = jleg.generate_rotate_translate_matrices(
            jnp.asarray(pos), jnp.asarray(look), jnp.asarray(up))
        cj = {"camera_rot": r, "camera_trans": t}
        r, t = tleg.generate_rotate_translate_matrices(
            *(torch.from_numpy(x) for x in (pos, look, up)))
        ct = {"camera_rot": r, "camera_trans": t}
    ws = [RNG.randn(2, faces.shape[0], 3, 3).astype(np.float32),
          RNG.randn(2, faces.shape[0], 3, 2).astype(np.float32),
          RNG.randn(2, faces.shape[0], 3).astype(np.float32)]

    def loss_j(v):
        outs = jutils.prepare_vertices(v, faces, proj_j, **cj)
        return sum(jnp.sum(jnp.asarray(w) * o) for w, o in zip(ws, outs))

    want = jax.jit(lambda v: jutils.prepare_vertices(v, faces, proj_j,
                                                     **cj))(jnp.asarray(verts))
    vt = torch.tensor(verts, requires_grad=True)
    got = tutils.prepare_vertices(vt, faces, proj_t, **ct)
    for g, w in zip(got, want):
        close(g, w, atol=5e-5)
    sum((torch.from_numpy(w) * o).sum() for w, o in zip(ws, got)).backward()
    gj = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(verts)))
    close(vt.grad, gj, atol=1e-4 * np.abs(gj).max())


def _capacity_case():
    v, f = load_example().uv_sphere(10, 16)
    img = (v[f][None, ..., :2] * np.float32(0.7)).astype(np.float32)
    return np.concatenate([img, img * 0.5]), (np.arange(f.shape[0]) % 3
                                              != 0)


@pytest.mark.parametrize("kw", [
    {}, {"tile_px": 16, "boxlen": 0.05}, {"headroom": 3.0, "tile_px": 8}])
def test_suggest_tile_cap_matches_jax(kw):
    fvi, _ = _capacity_case()
    assert trast.suggest_tile_cap(torch.from_numpy(fvi), 64, 64, **kw) == \
        jrast.suggest_tile_cap(jnp.asarray(fvi), 64, 64, **kw)
    assert tmesh.suggest_tile_cap is trast.suggest_tile_cap


@pytest.mark.parametrize("kw", [
    {}, {"tile_cap": 20}, {"tile_cap": 5, "tile_px": 16, "margin_boxlen": 0.02},
    {"valid": True, "tile_cap": 10}])
def test_tile_overflow_report_matches_jax(kw):
    fvi, valid = _capacity_case()
    kw = dict(kw)
    if kw.pop("valid", False):
        kw["valid_faces"] = np.stack([valid, ~valid])
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jrast.tile_overflow_report(jnp.asarray(fvi), 64, 64, **jkw)
    got = trast.tile_overflow_report(torch.from_numpy(fvi), 64, 64, **tkw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if "tile_cap" in kw:
        assert bool(got["any_overflow"].any())


def test_exports_match_jax():
    """The ported modules' names that ``kaolin_tpu.render.mesh``,
    ``kaolin_tpu.render.camera``, ``kaolin_tpu.render.lighting``,
    ``kaolin_tpu.render.easy_render``, ``kaolin_tpu.render.materials``,
    ``kaolin_tpu.rep``, ``kaolin_tpu.ops.conversions``,
    ``kaolin_tpu.non_commercial``, ``kaolin_tpu.ops.voxelgrid`` and the
    modules of ``kaolin_tpu.metrics`` export, the port's packages export
    too."""
    import kaolin_tpu.metrics as jmetrics
    import kaolin_tpu.non_commercial as jnc
    import kaolin_tpu.ops.conversions as jconv
    import kaolin_tpu.ops.voxelgrid as jvg
    import kaolin_tpu.render.camera as jc
    import kaolin_tpu.render.easy_render as jer
    import kaolin_tpu.render.lighting as jl
    import kaolin_tpu.render.materials as jmat
    import kaolin_tpu.render.mesh as jm
    import kaolin_tpu.rep as jrep
    import kaolin_tpu_torch.metrics as tmetrics
    import kaolin_tpu_torch.non_commercial as tnc
    import kaolin_tpu_torch.ops.conversions as tconv
    import kaolin_tpu_torch.ops.voxelgrid as tvg
    import kaolin_tpu_torch.render.camera as tc
    import kaolin_tpu_torch.render.easy_render as ter
    import kaolin_tpu_torch.render.lighting as tl
    import kaolin_tpu_torch.render.materials as tmat
    import kaolin_tpu_torch.rep as trep

    not_ported = set()
    metric_modules = [(getattr(jmetrics, n), getattr(tmetrics, n))
                      for n in dir(jmetrics) if not n.startswith("_")
                      and isinstance(getattr(jmetrics, n), type(os))]
    assert len(metric_modules) == 5
    for jmod, tmod in ((jm, tmesh), (jc, tc), (jconv, tconv), (jnc, tnc),
                       (jvg, tvg), (jl, tl), (jer, ter), (jmat, tmat),
                       (jrep, trep), *metric_modules):
        names = {n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(os))}
        missing = sorted(n for n in names - not_ported if not hasattr(tmod, n))
        assert not missing, missing
    assert hasattr(tc, "legacy") and tc.legacy.__name__.endswith("legacy")

    # io, its modules, ops and utils.testing: their names, and for a
    # package its own submodules too
    import kaolin_tpu.io as jio
    import kaolin_tpu.ops as jops
    import kaolin_tpu.utils.testing as jtesting
    import kaolin_tpu_torch.io as tio
    import kaolin_tpu_torch.ops as tops
    import kaolin_tpu_torch.utils.testing as ttesting
    for jmod, tmod, not_ported in (
            (jio, tio, set()), (jops, tops, set()),
            *((getattr(jio, m), getattr(tio, m), set())
              for m in ("obj", "gltf", "ply", "utils", "dataset", "usd")),
            (jtesting, ttesting, set())):
        names = {n for n in dir(jmod) if not n.startswith("_") and (
            not isinstance(getattr(jmod, n), type(os))
            or getattr(jmod, n).__name__.startswith(jmod.__name__ + "."))}
        missing = sorted(n for n in names - not_ported if not hasattr(tmod, n))
        assert not missing, (jmod.__name__, missing)
    assert {"gcn", "random", "coords", "reduction"} <= set(dir(tops))

    # the remaining packages and modules: their ``__all__`` where they
    # have one, else their public names, and a package's own submodules;
    # left out only the departures that ROADMAP.md's Queue C records
    import importlib
    import importlib.util

    import kaolin_tpu.experimental.newton  # noqa: F401
    import kaolin_tpu.parallel  # noqa: F401
    import kaolin_tpu_torch.experimental.newton  # noqa: F401
    import kaolin_tpu_torch.parallel  # noqa: F401
    departures = {"utils": {"on_tpu", "pallas_interpret"}}
    for name in ("physics", "physics.simplicits",
                 "physics.simplicits.network", "physics.simplicits.training",
                 "math.quat", "ops.spc", "render.spc", "visualize", "native",
                 "experimental", "experimental.newton", "parallel",
                 "parallel.ops", "parallel.simplicits", "utils"):
        jmod = importlib.import_module(f"kaolin_tpu.{name}")
        tmod = importlib.import_module(f"kaolin_tpu_torch.{name}")
        names = set(getattr(jmod, "__all__", ())) or {
            n for n in dir(jmod) if not n.startswith("_") and (
                not isinstance(getattr(jmod, n), type(os))
                or getattr(jmod, n).__name__.startswith(jmod.__name__ + "."))}
        names -= departures.get(name, set())
        # a submodule is an attribute only once something imported it
        missing = sorted(n for n in names if not hasattr(tmod, n) and (
            importlib.util.find_spec(f"{tmod.__name__}.{n}") is None))
        assert not missing, (name, missing)
    from kaolin_tpu_torch import utils as tutils
    assert not any(hasattr(tutils, n) for n in departures["utils"])


# -- goldens -------------------------------------------------------------
def _golden(name):
    from PIL import Image
    return np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")),
                      dtype=np.float32) / 255.0


def _sphere(n_lat=24, n_lon=32):
    """``golden_corpus._sphere_mesh`` in numpy (its ring starts 0.15 from
    each pole)."""
    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    f = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            f += [[a, b, c], [b, d, c]]
    return (torch.from_numpy(v.astype(np.float32)),
            torch.from_numpy(np.asarray(f, np.int64)))


def _camera(res=128):
    return Camera.from_args(eye=torch.tensor([1.6, 1.2, 1.8]),
                            at=torch.zeros(3),
                            up=torch.tensor([0.0, 1.0, 0.0]), fov=0.8,
                            width=res, height=res)


def _project(cam, verts, faces):
    vc = cam.extrinsics.transform(verts[None])
    vi = cam.intrinsics.transform(vc)[..., :2]
    return (index_vertices_by_faces(vc, faces)[..., 2],
            index_vertices_by_faces(vi, faces))


def test_golden_rasterize_normals():
    verts, faces = _sphere()
    fvz, fvi = _project(_camera(), verts, faces)
    normals = face_normals(index_vertices_by_faces(verts[None], faces),
                           unit=True)
    feat = normals[:, :, None, :].expand(-1, -1, 3, -1) * 0.5 + 0.5
    img, _ = tmesh.rasterize(128, 128, fvz, fvi, feat, impl="xla")
    assert_images_close(_golden("rasterize_normals"),
                        np.clip(img[0].numpy(), 0.0, 1.0),
                        pixel_disagreement_threshold=0.1,
                        max_percent_disagreeing_pixels=1.0)


def test_golden_dibr_soft_mask():
    """As the corpus calls it, ``rast_backend="xla"`` included (F17: the
    port refused that name before)."""
    verts, faces = _sphere(10, 14)
    fvz, fvi = _project(_camera(), verts * 0.7, faces)
    feat = torch.ones(fvi.shape[:2] + (3, 1))
    nz = torch.ones(fvi.shape[:2])
    _, soft, _ = tmesh.dibr_rasterization(128, 128, fvz, fvi, feat, nz,
                                          sigmainv=3000, rast_backend="xla")
    assert_images_close(_golden("dibr_soft_mask"),
                        np.clip(soft[0].numpy(), 0.0, 1.0),
                        pixel_disagreement_threshold=0.1,
                        max_percent_disagreeing_pixels=1.0)


@pytest.mark.parametrize("name", ["torch_tutorial_camera_rasterization",
                                  "torch_tutorial_bbox_fitting"])
def test_tutorial_smoke(name):
    """The two ported tutorials at their smoke sizes on the CPU; each
    asserts what its JAX counterpart asserts."""
    load_example(name).main("cpu", smoke=True)
