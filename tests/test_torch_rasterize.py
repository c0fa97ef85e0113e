"""kaolin_tpu_torch rasterizer against kaolin_tpu's, on the CPU.

The same numpy inputs go to both packages. On CPU tensors the port takes
the plain winner search, the oracle of the CUDA kernel; the JAX side runs
its brute XLA search and its Pallas kernel in interpret mode. Face ids must
be equal; images agree to 1e-6, and gradients to 1e-5 after division by
max(1, max|gradient|). The fvi gradients reach several hundred, where one
float32 ulp is above 1e-5, and the two frameworks sum their per-pixel terms
in different orders (measured: 4e-7 of the largest entry).

The re-gather kernels' wrappers (``cuda_regather``): their argument checks
and launch counters, and ``_Regather``, the autograd Function the card
runs, with its two kernels swapped for plain functions that follow their
rule (the forward is the plain version; the backward adds nothing from a
miss or from a pixel whose cotangent is 0, and its gradients come from the
winners' barycentrics analytically: ``chip_smoke.regather_bwd_rule``),
held to autograd through the plain re-gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render.mesh.rasterization import (
    _pixel_coords as _pixel_coords_jax,
    rasterize as rasterize_jax,
)
from chip_smoke import adversarial_faces, regather_bwd_rule, with_depth
from kaolin_tpu_torch.render.mesh import cuda_rasterize, cuda_regather
from kaolin_tpu_torch.render.mesh import rasterization as trast
from kaolin_tpu_torch.render.mesh.rasterization import (
    _pixel_coords,
    rasterize,
    tile_face_lists,
)
from kaolin_tpu_torch.utils import profiling
from kaolin_tpu_torch.utils.interop import from_numpy_tree
from tests.torch_parity import (  # noqa: F401
    grid_faces,
    load_example,
    torch_threads_per_worker,
    warm_torch_exp,
)


def random_scene(seed, b, f, scale=0.4, feat_dim=4):
    """Random faces. ``face_normals_z`` is random with face 0 exactly 0 (kept:
    the rule is ``>= 0``) and face 1 negative (culled)."""
    rng = np.random.RandomState(seed)
    tri = rng.randn(b, f, 3, 3).astype(np.float32) * scale
    nz = rng.randn(b, f).astype(np.float32)
    nz[:, 0] = 0.0
    nz[:, 1] = -1.0
    return {"fvz": tri[..., 2] - 2.0, "fvi": tri[..., :2],
            "feats": rng.rand(b, f, 3, feat_dim).astype(np.float32),
            "valid": nz >= 0}


def grid_scene(feat_dim=3):
    """The planar grid of :func:`grid_faces` at one depth: at 32² every
    pixel centre on a cell diagonal ties in z between two faces, so the
    lowest id must win exactly."""
    fvi = grid_faces()
    f = fvi.shape[1]
    rng = np.random.RandomState(5)
    return {"fvz": np.full((1, f, 3), -2.0, np.float32), "fvi": fvi,
            "feats": rng.rand(1, f, 3, feat_dim).astype(np.float32),
            "valid": np.ones((1, f), bool)}


def _run_jax(scene, h, w, **kw):
    fvz = jnp.asarray(scene["fvz"])
    valid = jnp.asarray(scene["valid"])

    def loss(fvi, feats):
        img, idx = rasterize_jax(h, w, fvz, fvi, feats, valid_faces=valid,
                                 **kw)
        return jnp.sum(img ** 2), (img, idx)

    (_, (img, idx)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(scene["fvi"]),
                                            jnp.asarray(scene["feats"]))
    return (np.asarray(img), np.asarray(idx),
            [np.asarray(g) for g in grads])


def _run_torch(scene, h, w):
    t = from_numpy_tree(scene, "cpu")
    fvi = t["fvi"].requires_grad_(True)
    feats = t["feats"].requires_grad_(True)
    img, idx = rasterize(h, w, t["fvz"], fvi, feats, valid_faces=t["valid"])
    torch.sum(img ** 2).backward()
    return (img.detach().numpy(), idx.numpy(),
            [fvi.grad.numpy(), feats.grad.numpy()])


def _assert_parity(got, want):
    img_t, idx_t, g_t = got
    img_j, idx_j, g_j = want
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(img_t, img_j, atol=1e-6)
    for a, b in zip(g_t, g_j):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5)


def test_pixel_coords_bitwise():
    for h, w in ((72, 100), (32, 32)):
        px_j, py_j = _pixel_coords_jax(h, w, 1000, jnp.float32)
        px_t, py_t = _pixel_coords(h, w, 1000, torch.float32, "cpu")
        np.testing.assert_array_equal(px_t.numpy(), np.asarray(px_j))
        np.testing.assert_array_equal(py_t.numpy(), np.asarray(py_j))


def test_rasterize_matches_jax_brute():
    """Ragged 72x100 (neither side a multiple of 16), two batch elements,
    200 faces (more than one chunk of the plain search)."""
    scene = random_scene(0, 2, 200)
    want = _run_jax(scene, 72, 100, backend="brute", impl="xla")
    got = _run_torch(scene, 72, 100)
    assert (got[1] >= 0).any() and (got[1] == -1).any()
    _assert_parity(got, want)


def test_rasterize_matches_jax_brute_on_shared_edges():
    scene = grid_scene()
    want = _run_jax(scene, 32, 32, backend="brute", impl="xla")
    got = _run_torch(scene, 32, 32)
    _assert_parity(got, want)


def test_rasterize_matches_jax_pallas():
    """Against the Pallas winner kernel (interpret mode), which needs the
    image sides to be multiples of its 16-pixel tile."""
    scene = random_scene(4, 2, 200)
    want = _run_jax(scene, 32, 48, impl="pallas")
    got = _run_torch(scene, 32, 48)
    _assert_parity(got, want)


def test_zero_area_faces_stay_in_their_box():
    """A face is tested only inside its closed bounding box. A point face
    away from every pixel centre then covers nothing, where the JAX brute
    search gives it every pixel (its barycentrics are all 0, so z = 0 wins);
    a collinear face on a pixel row covers only that row's pixels inside its
    box. Every other pixel matches JAX with the two faces left out."""
    h = w = 16
    y = (h - 2 * 5 - 1) / h               # the centre of pixel row 5
    tri = [[-0.3, -0.3], [0.3, -0.3], [0.0, 0.3]]
    fvi = np.array([[[[0.1, 0.1]] * 3, [[-0.5, y], [0.0, y], [0.2, y]], tri]],
                   np.float32)
    scene = {"fvz": np.full((1, 3, 3), -2.0, np.float32), "fvi": fvi,
             "feats": np.ones((1, 3, 3, 1), np.float32),
             "valid": np.ones((1, 3), bool)}
    def jax_ids(s):
        return np.asarray(rasterize_jax(
            h, w, jnp.asarray(s["fvz"]), jnp.asarray(s["fvi"]),
            jnp.asarray(s["feats"]), backend="brute", impl="xla")[1])

    assert (jax_ids(scene) == 0).all()
    want = jax_ids({k: v[:, 2:] for k, v in scene.items()})
    want = np.where(want >= 0, want + 2, -1)

    idx = _run_torch(scene, h, w)[1]
    line = idx == 1
    px = _pixel_coords(h, w, 1000, torch.float32, "cpu")[0].numpy()[None]
    assert line.any() and not (idx == 0).any()
    assert line[:, 5].sum() == line.sum()
    assert (px[line] >= -500).all() and (px[line] <= 200).all()
    np.testing.assert_array_equal(idx[~line], want[~line])


def test_rasterize_feature_list():
    scene = random_scene(2, 1, 20, feat_dim=5)
    t = from_numpy_tree(scene, "cpu")
    feats = [t["feats"][..., :2], t["feats"][..., 2:]]
    imgs, idx = rasterize(16, 24, t["fvz"], t["fvi"], feats,
                          valid_faces=t["valid"])
    img, idx2 = rasterize(16, 24, t["fvz"], t["fvi"], t["feats"],
                          valid_faces=t["valid"])
    assert [x.shape[-1] for x in imgs] == [2, 3]
    torch.testing.assert_close(torch.cat(imgs, -1), img, rtol=0, atol=0)
    assert torch.equal(idx, idx2)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes only CUDA tensors; it never falls back."""
    scene = from_numpy_tree(random_scene(0, 1, 4), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rasterize.rasterize_search_cuda(
            scene["fvz"], scene["fvi"] * 1000, scene["valid"], 1000, 1e-8,
            16, 16)
    assert profiling.counters()[cuda_rasterize.LAUNCHES] == 0


def _cull_case(case):
    """Scaled faces (B, F, 3, 2) float32, validity (B, F) and the image
    size of a tile-cull case."""
    if case == "adversarial":
        fvi, _, h, w = adversarial_faces()
        return fvi, with_depth(fvi, 11)["valid"], h, w
    if case == "random":
        scene = random_scene(0, 2, 200)
        return scene["fvi"] * np.float32(1000.0), scene["valid"], 72, 100
    inputs = load_example().config2_inputs()
    fvi = inputs["face_vertices_image"] * np.float32(1000.0)
    return fvi, inputs["face_normals_z"] >= 0, 128, 128


@pytest.mark.parametrize("kernel", ["winner", "soft_mask_fwd"])
@pytest.mark.parametrize("case", ["adversarial", "random", "sphere128"])
def test_tile_cull_loses_no_pair(case, kernel):
    """The kernels' tile cull and ordered face list (tile_face_lists, their
    plain model) lose no pair: every (pixel, face) pair in the face's closed
    box (the winner search, valid faces only) or in its enlarged half-open
    box (the soft mask, margin 20) has its face in the list of the pixel's
    tile (cuda_rasterize.TILE pixels a side). The lists are ascending and
    hold no culled face."""
    fvi, valid, h, w = _cull_case(case)
    winner = kernel == "winner"
    margin = 0.0 if winner else 0.02 * 1000.0
    v = torch.from_numpy(fvi)
    ok = torch.from_numpy(valid) if winner else torch.ones(valid.shape,
                                                           dtype=torch.bool)
    lists = tile_face_lists(v, h, w, 1000, margin=margin,
                            valid_mask=ok if winner else None)
    px, py = _pixel_coords(h, w, 1000, torch.float32, "cpu")
    xs, ys = px[0], py[:, 0]
    lo, hi = v.amin(dim=2) - margin, v.amax(dim=2) + margin   # (B, F, 2)

    def inside(c, k):   # (B, F, n): pixel centres c in the box along axis k
        up = (c <= hi[..., k, None]) if winner else (c < hi[..., k, None])
        return (c >= lo[..., k, None]) & up

    cols, rows = inside(xs, 0), inside(ys, 1)
    b, f = valid.shape
    n = cuda_rasterize.TILE
    ty, tx = -(-h // n), -(-w // n)
    pairs = 0
    for i in range(b):
        assert len(lists[i]) == ty * tx
        for t, ids in enumerate(lists[i]):
            r, c = divmod(t, tx)
            need = (rows[i, :, n * r:n * r + n].any(-1)
                    & cols[i, :, n * c:n * c + n].any(-1) & ok[i])
            listed = torch.zeros(f, dtype=torch.bool)
            listed[ids] = True
            assert bool((listed[need]).all()), (i, t)
            assert bool((ids[1:] > ids[:-1]).all()) and bool(ok[i][ids].all())
            pairs += int(need.sum())
    assert pairs > 0


@pytest.mark.parametrize("case", ["random", "adversarial", "grid"])
def test_chunk_windows_compute_what_the_whole_image_computes(case,
                                                             monkeypatch):
    """The plain versions compute each chunk of faces on the window of
    pixels its boxes can hold (``chunk_window``); given the rasterizer's
    ids, the forward only at the window's uncovered pixels, and the
    backward only where the cotangent is not 0. With the window made the
    whole image and every pixel visited, the winner ids and the soft-mask
    forward (both ``knum`` modes, and with the ids) are bit for bit the
    same: what is left out is only pixels that no box of the chunk holds
    or that the ids cover. The plain backward sums the same non-zero
    per-pixel terms over fewer pixels, so it agrees within 1e-6 of its
    largest entry. Faces off the image, on box edges at pixel
    centres and over the whole image (``adversarial_faces``) included."""
    from kaolin_tpu_torch.render.mesh import dibr, rasterization

    if case == "adversarial":
        fvi, g, h, w = adversarial_faces()
        d = from_numpy_tree({**with_depth(fvi, 11), "g": g}, "cpu")
        d["fvi"] = d["fvi"] / 1000.0
    else:
        d = from_numpy_tree(random_scene(3, 2, 140, scale=0.3)
                            if case == "random" else grid_scene(), "cpu")
        h, w = (24, 40) if case == "random" else (32, 32)
        d["g"] = torch.from_numpy(np.random.RandomState(1).randn(
            d["fvi"].shape[0], h, w).astype(np.float32))
    if "valid" not in d:
        d["valid"] = torch.ones(d["fvi"].shape[:2], dtype=torch.bool)
    scaled = d["fvi"] * 1000.0

    def run():
        ids = rasterization.rasterize_search_plain(
            d["fvz"], scaled, d["valid"], 1000, 1e-8, h, w)
        fwd = [dibr.soft_mask_plain(scaled, 700.0, 0.05, 1000.0, h, w,
                                    knum=k) for k in (None, 5)]
        fwd.append(dibr.soft_mask_plain(scaled, 700.0, 0.05, 1000.0, h, w,
                                        face_idx=ids))
        ga = torch.where(ids >= 0, 0.0, d["g"])     # the path's cotangent
        bwd = dibr._soft_mask_bwd_plain(scaled, ga, 700.0, 0.05, 1000.0,
                                        h, w)
        return [ids, *fwd, bwd]

    windowed = run()
    whole = lambda *a, **k: (slice(0, a[2]), slice(0, a[3]))   # noqa: E731
    monkeypatch.setattr(rasterization, "chunk_window", whole)
    monkeypatch.setattr(dibr, "chunk_window", whole)
    boxes = dibr._chunk_boxes

    def every_pixel(*a):    # the pixels of the whole window, needed or not
        a = list(a)
        if len(a) > 6 and a[6] is not None:
            a[6] = torch.ones_like(a[6])
        return boxes(*a)

    monkeypatch.setattr(dibr, "_chunk_boxes", every_pixel)
    full = run()
    for a, b in zip(windowed[:4], full[:4]):
        assert torch.equal(a, b)
    assert torch.equal(windowed[3],
                       torch.where(windowed[0] >= 0, 1.0, full[1]))
    err = float((windowed[4] - full[4]).abs().max() / full[4].abs().max())
    assert err <= 1e-6, err
    assert bool((windowed[0] >= 0).any())


def _regather_inputs(case, d, seed=0):
    """(face_idx (B, H, W), scaled (B, F, 3, 2), features (B, F, 3, D),
    cotangent (B, H, W, D)) of a re-gather case: ``random`` (200 faces at
    72x100, about half the pixels missed) or ``grid`` (the planar grid at
    32², every face shared by the pixels of its cell). The cotangent is
    random everywhere, misses included, but 0 in every channel at a tenth
    of the hits and along one pixel row."""
    scene = random_scene(seed, 2, 200, feat_dim=d) if case == "random" \
        else grid_scene(feat_dim=d)
    h, w = (72, 100) if case == "random" else (32, 32)
    t = from_numpy_tree(scene, "cpu")
    scaled = t["fvi"] * 1000.0
    idx = trast.rasterize_search_plain(t["fvz"], scaled, t["valid"], 1000,
                                       1e-8, h, w)
    rng = np.random.RandomState(seed + 1)
    g = rng.randn(*idx.shape, d).astype(np.float32)
    g[(rng.rand(*idx.shape) < 0.1) & (idx.numpy() >= 0)] = 0.0
    g[:, h // 2] = 0.0
    return idx, scaled, t["feats"], torch.from_numpy(g)


def _plain_regather(monkeypatch):
    """``cuda_regather``'s two wrappers swapped for plain functions that
    follow the kernels' rule → the list of the gradients each backward is
    asked for."""
    asked = []

    def fwd(face_idx, scaled, features, multiplier, eps):
        with torch.no_grad():
            return trast.interpolate_at_winners_plain(
                face_idx, scaled, features, multiplier, eps)

    def bwd(face_idx, scaled, features, grad_out, multiplier, eps,
            need_scaled=True, need_features=True):
        asked.append((need_scaled, need_features))
        return regather_bwd_rule(face_idx, scaled, features, grad_out,
                                 multiplier, eps, need_scaled, need_features)

    monkeypatch.setattr(cuda_regather, "regather_fwd_cuda", fwd)
    monkeypatch.setattr(cuda_regather, "regather_bwd_cuda", bwd)
    return asked


@pytest.mark.parametrize("case,d,feature_grad,expanded", [
    ("random", 1, True, False), ("random", 3, False, False),
    ("random", 11, True, False), ("grid", 3, True, False),
    ("random", 3, True, True), ("random", 11, False, True)])
def test_regather_function_follows_the_plain_version(case, d, feature_grad,
                                                     expanded, monkeypatch):
    """``_Regather`` with the kernels' rule in place of the kernels, against
    autograd through ``interpolate_at_winners_plain``: values bit for bit,
    and the gradients of ``scaled`` and of the features within 1e-5 of
    their largest entry (the rule sums per face in another order) at D of
    1, 3 and 11, with misses and hits whose cotangent is 0 (they add
    nothing), faces shared by neighbouring pixels, features that require
    grad or not (the backward is asked for theirs only where they do), and
    a batch of features expanded from one view (its gradient reaches the
    view through the caller's expand)."""
    idx, scaled, feats, g = _regather_inputs(case, d)
    if expanded:
        feats = feats[:1]
    asked = _plain_regather(monkeypatch)
    got, want = {}, {}
    for out, route in ((got, True), (want, False)):
        s = scaled.clone().requires_grad_(True)
        leaf = feats.clone().requires_grad_(feature_grad)
        batch = leaf.expand(2, -1, -1, -1) if expanded else leaf
        if route:
            val = trast._Regather.apply(idx, s, batch, 1000, 1e-8)
        else:
            val = trast.interpolate_at_winners_plain(idx, s, batch, 1000,
                                                     1e-8)
        val.backward(g)
        out.update(val=val.detach(), gs=s.grad, gf=leaf.grad)
    assert asked == [(True, feature_grad)]
    assert torch.equal(got["val"], want["val"])
    assert bool((idx < 0).any()) and bool((idx >= 0).any())
    for k in ("gs", "gf"):
        if not feature_grad and k == "gf":
            assert got[k] is None and want[k] is None
            continue
        scale = float(want[k].abs().max())
        assert scale > 0
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale)


def test_regather_rule_skips_what_adds_nothing():
    """The kernels' rule takes nothing from a missed pixel or from a hit
    whose cotangent is 0, however large the cotangent at the misses: the
    gradients equal those of the cotangent zeroed there, bit for bit."""
    idx, scaled, feats, g = _regather_inputs("random", 3)
    live = (idx >= 0)[..., None] & (g != 0).any(-1, keepdim=True)
    loud = torch.where(idx[..., None] >= 0, g, 1e30)
    got = regather_bwd_rule(idx, scaled, feats, loud, 1000, 1e-8)
    want = regather_bwd_rule(idx, scaled, feats, g * live, 1000, 1e-8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_regather_backward_once_differentiable(monkeypatch):
    """The kernels' backward gives gradients with no graph: a second
    derivative through ``_Regather`` raises instead of coming out as
    missing or zero."""
    idx, scaled, feats, g = _regather_inputs("grid", 3)
    s = scaled.clone().requires_grad_(True)
    _plain_regather(monkeypatch)
    out = trast._Regather.apply(idx, s, feats, 1000, 1e-8)
    (gs,) = torch.autograd.grad((out * g).square().sum(), (s,),
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gs.sum().backward()


def _bad_regather_inputs():
    """(label, face_idx, scaled, features, error) that the re-gather
    kernels' checks refuse: each with one thing wrong, on the CPU."""
    idx = torch.zeros(2, 4, 5, dtype=torch.int32)
    scaled = torch.rand(2, 6, 3, 2)
    feats = torch.rand(2, 6, 3, 3)
    return [
        ("face_idx int64", idx.long(), scaled, feats, TypeError),
        ("scaled float64", idx, scaled.double(), feats, TypeError),
        ("features float64", idx, scaled, feats.double(), TypeError),
        ("face_idx (2, 20)", idx.reshape(2, 20), scaled, feats, ValueError),
        ("scaled (2, 6, 6)", idx, scaled.reshape(2, 6, 6), feats,
         ValueError),
        ("features (2, 6, 9)", idx, scaled, feats.reshape(2, 6, 9),
         ValueError),
        ("scaled (2, 6, 2, 3)", idx, scaled.reshape(2, 6, 2, 3), feats,
         ValueError),
        ("features of 5 faces", idx, scaled, feats[:, :5], ValueError),
        ("scaled batch 1", idx, scaled[:1], feats[:1], ValueError),
        ("on the CPU", idx, scaled, feats, ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_bad_regather_inputs())))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_regather_kernel_checks_raise(case, direction):
    """The wrappers refuse a wrong dtype, rank or shape, or CPU tensors,
    before any launch, forward and backward: the checks of type and shape
    come before the device's, so each raises here on the CPU."""
    label, idx, scaled, feats, error = _bad_regather_inputs()[case]
    with pytest.raises(error):
        if direction == "forward":
            cuda_regather.regather_fwd_cuda(idx, scaled, feats, 1000, 1e-8)
        else:
            grad = torch.zeros(*idx.shape, feats.shape[-1])
            cuda_regather.regather_bwd_cuda(idx, scaled, feats, grad, 1000,
                                            1e-8)
    got = profiling.counters()
    assert got[cuda_regather.FWD_LAUNCHES] == 0
    assert got[cuda_regather.BWD_LAUNCHES] == 0


def test_regather_launch_counters_listed():
    """Both launch counters are in the registry from the wrapper's import,
    at 0 where no card ran them, also after a CPU rasterization and its
    backward (the plain version); the backward's two pixel counters are
    device counters, listed only while the profiler runs."""
    got = profiling.counters()
    assert got[cuda_regather.FWD_LAUNCHES] == 0
    assert got[cuda_regather.BWD_LAUNCHES] == 0
    assert not set(cuda_regather.PIXELS) & set(got)
    t = from_numpy_tree(random_scene(1, 1, 20), "cpu")
    fvi = t["fvi"].requires_grad_(True)
    img, _ = rasterize(16, 24, t["fvz"], fvi, t["feats"],
                       valid_faces=t["valid"])
    img.sum().backward()
    got = profiling.counters()
    assert got[cuda_regather.FWD_LAUNCHES] == \
        got[cuda_regather.BWD_LAUNCHES] == 0
