"""kaolin_tpu_torch rasterizer against kaolin_tpu's, on the CPU.

The same numpy inputs go to both packages. On CPU tensors the port takes
the plain winner search, the oracle of the CUDA kernel; the JAX side runs
its brute XLA search and its Pallas kernel in interpret mode. Face ids must
be equal; images agree to 1e-6, and gradients to 1e-5 after division by
max(1, max|gradient|). The fvi gradients reach several hundred, where one
float32 ulp is above 1e-5, and the two frameworks sum their per-pixel terms
in different orders (measured: 4e-7 of the largest entry).
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
from chip_smoke import adversarial_faces, with_depth
from kaolin_tpu_torch.render.mesh import cuda_rasterize
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
