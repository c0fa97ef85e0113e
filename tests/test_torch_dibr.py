"""kaolin_tpu_torch soft mask and DIB-R slice against kaolin_tpu's, on the
CPU.

The same numpy inputs go to both packages. On CPU tensors the port takes
the plain all-faces soft mask, the oracle of the CUDA kernels, and its
autograd. Values agree to 1e-5 and gradients, divided by their largest
entry, to 2e-5: the tolerances the JAX package's own Pallas tests use.

Gradient oracles. ``_soft_mask_unbatched``, the JAX all-faces path, is right
in value, but its gradient drops terms at some pixels: ``jnp.min``'s
gradient goes to the candidates equal to the minimum, and when XLA
recomputes the candidates in another fusion (its scan body runs under
``jax.checkpoint``) some no longer equal it. Run op by op, the same formula
agrees with the Pallas VJP and with the port (ROADMAP, Queue C, F5). So
gradients are held against the Pallas backward kernel (interpret mode); for
the whole slice against the binned soft mask holding every face; and for
``knum_mode="first"``, which only the unbatched path has, against its
formula run op by op.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.metrics.render import mask_iou as mask_iou_jax
from kaolin_tpu.render.mesh.dibr import (
    _edge_vertex_sqdist,
    _soft_mask_binned,
    _soft_mask_unbatched,
    _soft_raw_pallas,
    dibr_rasterization as dibr_rasterization_jax,
)
from kaolin_tpu.render.mesh.rasterization import (
    _pixel_coords as _pixel_coords_jax,
    rasterize as rasterize_jax,
)
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.render.mesh import cuda_soft_mask
from chip_smoke import (
    EDGE_BOXLEN,
    EDGE_SIGMAINV,
    adversarial_faces,
    edge_pixel_faces,
)
from kaolin_tpu_torch.render.mesh.dibr import (
    _SoftMask,
    dibr_rasterization,
    dibr_soft_mask,
    soft_mask_plain,
)
from kaolin_tpu_torch.render.mesh.rasterization import (
    rasterize,
    rasterize_search_plain,
)
from kaolin_tpu_torch.utils import cuda_build, profiling
from kaolin_tpu_torch.utils.interop import from_numpy_tree
from tests.torch_parity import ROOT, grid_faces, warm_torch_exp  # noqa: F401
from tests.torch_parity import torch_threads_per_worker  # noqa: F401


def random_faces(seed, f, scale=0.3):
    """(1, F, 3, 2) random image-space faces."""
    rng = np.random.RandomState(seed)
    return (rng.randn(1, f, 3, 2) * scale).astype(np.float32)


def _assert_grads_close(got, want, atol=2e-5):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _torch_soft(fvi, h, w, knum_mode, knum, sigmainv, boxlen):
    """Port: dibr_soft_mask (through _SoftMask for "all"), and the plain
    soft mask called directly, with the gradient of sum(mask²)."""
    v = torch.from_numpy(fvi).requires_grad_(True)
    fidx = torch.full((1, h, w), -1, dtype=torch.int32)
    mask = dibr_soft_mask(v, fidx, sigmainv=sigmainv, boxlen=boxlen,
                          knum=knum, knum_mode=knum_mode)
    torch.sum(mask ** 2).backward()
    plain = 1.0 - soft_mask_plain(
        torch.from_numpy(fvi) * 1000.0, sigmainv, boxlen, 1000.0, h, w,
        knum=knum if knum_mode == "first" else None)
    return mask.detach().numpy()[0], plain.numpy()[0], v.grad.numpy()[0]


def _jax_value(fvi, h, w, sigmainv, boxlen, knum=None):
    fidx = jnp.full((h, w), -1, jnp.int32)
    return np.asarray(_soft_mask_unbatched(
        jnp.asarray(fvi[0]) * 1000.0, fidx, sigmainv, boxlen, 1000.0, h, w,
        knum=knum))


def _jax_soft_direct(v, h, w, sigmainv, boxlen, knum=None):
    """_soft_mask_unbatched for an uncovered image, in one broadcast over
    all faces instead of a checkpointed scan."""
    scaled = v * 1000.0
    px, py = _pixel_coords_jax(h, w, 1000.0, jnp.float32)
    px, py = px[..., None], py[..., None]
    bmin = jnp.min(scaled, axis=1) - boxlen * 1000.0
    bmax = jnp.max(scaled, axis=1) + boxlen * 1000.0
    include = ((px >= bmin[:, 0]) & (px < bmax[:, 0])
               & (py >= bmin[:, 1]) & (py < bmax[:, 1]))
    if knum is not None:
        include &= jnp.cumsum(include.astype(jnp.int32), -1) <= knum
    d2 = _edge_vertex_sqdist(px, py, scaled[None, None], 1000.0)
    prob = jnp.where(include, jnp.exp(-sigmainv * d2 / 1e6), 0.0)
    return 1.0 - jnp.prod(1.0 - prob, axis=-1)


def _jax_pallas(fvi, h, w, sigmainv, boxlen, tile_px, fidx=None):
    """The Pallas forward and backward kernels (interpret mode) → (soft,
    gradient of sum(soft²)); 1 where ``fidx`` (H, W) holds an id ≥ 0."""
    def loss(v):
        soft = _soft_raw_pallas(v * 1000.0, sigmainv, boxlen, 1000.0, h, w,
                                (tile_px, fvi.shape[1]))
        if fidx is not None:
            soft = jnp.where(jnp.asarray(fidx) >= 0, 1.0, soft)
        return jnp.sum(soft ** 2), soft

    (_, soft), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(fvi[0]))
    return np.asarray(soft), np.asarray(grad)


def _soft_case(case):
    """(faces (1, F, 3, 2), H, W, Pallas tile, sigmainv, boxlen)."""
    if case == "random":   # 130 faces: two chunks of the plain loop
        return random_faces(0, 130), 32, 48, 16, 7000.0, 0.02
    # 152 in-box pixel-face pairs with tied distance candidates
    return grid_faces(), 32, 32, 32, 1000.0, 0.1


@pytest.mark.parametrize("case", ["random", "grid_ties"])
def test_soft_mask_all_matches_jax(case):
    """knum_mode="all" (through _SoftMask on the CPU) and the plain soft
    mask: values against _soft_mask_unbatched, the JAX path dibr_soft_mask
    runs at these face counts, and against the Pallas kernels; gradients
    against the Pallas backward."""
    fvi, h, w, tile_px, sigmainv, boxlen = _soft_case(case)
    want = _jax_value(fvi, h, w, sigmainv, boxlen)
    pallas, g_want = _jax_pallas(fvi, h, w, sigmainv, boxlen, tile_px)
    mask, plain, grad = _torch_soft(fvi, h, w, "all", 30, sigmainv, boxlen)
    assert 0.01 < float(want.max()) <= 1.0
    for got in (mask, plain, pallas):
        np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_grads_close(grad, g_want)


@pytest.mark.parametrize("case", ["random", "grid_ties"])
def test_soft_mask_face_idx_is_exact(case):
    """dibr_soft_mask hands the rasterizer's ids to _SoftMask, which skips
    the covered pixels: its mask and gradient are bit for bit those of the
    same mask with allprob computed at every pixel, and still match JAX's
    dibr soft mask with the same ids (values) and the Pallas VJP with the
    covered pixels set to 1 (gradients)."""
    fvi, h, w, tile_px, sigmainv, boxlen = _soft_case(case)
    f = fvi.shape[1]
    fvz = np.random.RandomState(2).uniform(-3, -1, (1, f, 3))
    idx = rasterize_search_plain(
        torch.from_numpy(fvz.astype(np.float32)),
        torch.from_numpy(fvi) * 1000.0, torch.ones((1, f), dtype=torch.bool),
        1000.0, 1e-8, h, w)
    assert bool((idx >= 0).any()) and bool((idx < 0).any())

    def run(with_idx):
        v = torch.from_numpy(fvi).requires_grad_(True)
        if with_idx:
            mask = dibr_soft_mask(v, idx, sigmainv=sigmainv, boxlen=boxlen)
        else:
            allprob = _SoftMask.apply(v * 1000.0, sigmainv, boxlen, 1000.0, h,
                                      w)
            mask = torch.where(idx >= 0, 1.0, 1.0 - allprob)
        torch.sum(mask ** 2).backward()
        return mask.detach(), v.grad

    (mask, grad), (mask0, grad0) = run(True), run(False)
    assert torch.equal(mask.view(torch.int32), mask0.view(torch.int32))
    assert torch.equal(grad.view(torch.int32), grad0.view(torch.int32))
    fidx = idx[0].numpy()
    want = np.asarray(_soft_mask_unbatched(
        jnp.asarray(fvi[0]) * 1000.0, jnp.asarray(fidx), sigmainv, boxlen,
        1000.0, h, w))
    np.testing.assert_allclose(mask[0].numpy(), want, atol=1e-5)
    _, g_want = _jax_pallas(fvi, h, w, sigmainv, boxlen, tile_px, fidx)
    _assert_grads_close(grad[0].numpy(), g_want)


def test_soft_mask_first_knum_matches_jax():
    """knum_mode="first", each pixel keeping its first 5 in-box faces:
    values against _soft_mask_unbatched(knum=5), gradients against the
    same formula without the checkpointed scan (run op by op: under jit,
    XLA's fusion loses the same terms)."""
    fvi, h, w, knum = random_faces(1, 60, scale=0.1), 32, 32, 5
    sigmainv, boxlen = 7000.0, 0.02
    want = _jax_value(fvi, h, w, sigmainv, boxlen, knum=knum)

    def loss(v):
        soft = _jax_soft_direct(v, h, w, sigmainv, boxlen, knum)
        return jnp.sum(soft ** 2), soft

    (_, direct), g_want = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(fvi[0]))
    mask, plain, grad = _torch_soft(fvi, h, w, "first", knum, sigmainv,
                                    boxlen)
    all_faces = _torch_soft(fvi, h, w, "all", knum, sigmainv, boxlen)[0]
    assert float(np.abs(all_faces - mask).max()) > 0.05  # truncation bites
    for got in (mask, plain, np.asarray(direct)):
        np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_grads_close(grad, np.asarray(g_want))


def test_soft_mask_adversarial_case_matches_jax():
    """The case the backward kernel is held against on the card
    (``chip_smoke.adversarial_faces``, 72x100, B = 2): on the CPU the
    port's all-faces soft mask (``_SoftMask``) and its gradient against
    JAX's binned soft mask holding every face and its analytic VJP. The
    case holds what it is for: enlarged-box edges on pixel centres, faces
    with no pixel in the image, and a face whose box holds the whole
    image."""
    fvi, g, h, w = adversarial_faces()
    b, f = fvi.shape[:2]
    v = torch.from_numpy(fvi).requires_grad_(True)
    allprob = _SoftMask.apply(v, 7000.0, 0.02, 1000.0, h, w)
    torch.sum(allprob * torch.from_numpy(g)).backward()

    def loss(fv):
        soft = jax.vmap(lambda a, s: _soft_mask_binned(
            a, s, 7000.0, 0.02, 1000.0, h, w, tile_px=4, cap=f))(
                fv, jnp.full((b, h, w), -1, jnp.int32))
        return jnp.sum((1.0 - soft) * g), soft

    (_, soft), g_want = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(fvi))
    # the edge distances of faces far from the image centre cancel large
    # terms (C = x2·y1 − x1·y2 near 6e5 here), where XLA's fused
    # multiply-adds and the port's separate roundings part by up to 3e-5
    np.testing.assert_allclose(allprob.detach().numpy(),
                               1.0 - np.asarray(soft), atol=5e-5)
    _assert_grads_close(v.grad.numpy(), np.asarray(g_want))

    px, py = _pixel_coords_jax(h, w, 1000.0, jnp.float32)
    xs, ys = np.asarray(px)[0], np.asarray(py)[:, 0]
    lo = fvi.min(axis=2) - np.float32(20.0)
    hi = fvi.max(axis=2) + np.float32(20.0)
    assert np.isin(lo[..., 0], xs).sum() >= 12
    assert np.isin(hi[..., 1], ys).sum() >= 12
    inside = (((xs >= lo[..., None, 0]) & (xs < hi[..., None, 0])).sum(-1)
              * ((ys >= lo[..., None, 1]) & (ys < hi[..., None, 1])).sum(-1))
    assert (inside == 0).sum() >= 4 and inside.max() == h * w > 4096


def test_soft_mask_gradient_is_zero_where_a_factor_rounds_to_zero():
    """F11: an uncovered pixel centre 0.001 from a face's edge, where that
    face's 1 − p rounds to 0 and allprob is 0. The port's all-faces
    gradient on the CPU takes the backward kernel's rule, the cotangent
    ga·k·p/(1 − p) with ga = grad·allprob: a cotangent at that pixel alone
    gives every face exactly 0, as JAX's Pallas VJP (interpret mode) does,
    where autograd through the product would not. A seeded cotangent over
    the whole image gives the Pallas VJP's gradient."""
    fvi, g, h, w, (r, c) = edge_pixel_faces()
    args = (EDGE_SIGMAINV, EDGE_BOXLEN, 1000.0, h, w)
    only = np.zeros_like(g)
    only[0, r, c] = 1.0

    def port(cot):
        v = torch.from_numpy(fvi).requires_grad_(True)
        allprob = _SoftMask.apply(v, *args)
        allprob.backward(torch.from_numpy(cot))
        return allprob.detach().numpy(), v.grad.numpy()

    def pallas(cot):
        soft, vjp = jax.vjp(lambda v: _soft_raw_pallas(
            v, *args[:3], h, w, (16, fvi.shape[1])), jnp.asarray(fvi[0]))
        return np.asarray(soft), np.asarray(vjp(-jnp.asarray(cot[0]))[0])

    allprob, grad = port(only)
    soft_j, grad_j = pallas(only)
    assert allprob[0, r, c] == 0.0 and soft_j[r, c] == 1.0
    assert not grad.any() and not grad_j.any()
    v = torch.from_numpy(fvi).requires_grad_(True)
    (by_product,) = torch.autograd.grad(soft_mask_plain(v, *args), v,
                                        torch.from_numpy(only))
    assert by_product.abs().max() > 0      # the case bites
    allprob, grad = port(g)
    soft_j, grad_j = pallas(g)
    np.testing.assert_allclose(allprob[0], 1.0 - soft_j, atol=1e-5)
    _assert_grads_close(grad[0], grad_j)


def _jax_style_case():
    rng = np.random.RandomState(4)
    b, f, h, w = 1, 30, 32, 48
    tri = (rng.randn(b, f, 3, 3) * 0.4).astype(np.float32)
    nz = rng.randn(b, f).astype(np.float32)
    return from_numpy_tree({"fvz": tri[..., 2] - 2.0, "fvi": tri[..., :2],
                            "feats": rng.rand(b, f, 3, 2).astype(np.float32),
                            "nz": nz}, "cpu"), h, w


def test_jax_style_calls_give_the_same_results():
    """F12: the JAX package's arguments in its positions (backend, tile_px,
    tile_cap, impl of rasterize; tile_px, tile_cap, impl before knum_mode
    in dibr_soft_mask; rast_backend, tile_px, tile_cap of
    dibr_rasterization), positional and by keyword, give bit for bit what
    the calls without them give; the values are checked as JAX checks
    them."""
    t, h, w = _jax_style_case()
    valid = t["nz"] >= 0
    img, idx = rasterize(h, w, t["fvz"], t["fvi"], t["feats"],
                         valid_faces=valid)
    for got in (rasterize(h, w, t["fvz"], t["fvi"], t["feats"], valid, None,
                          None, "brute", 16, 64, "xla"),
                rasterize(h, w, t["fvz"], t["fvi"], t["feats"],
                          valid_faces=valid, backend="binned", tile_px=16,
                          tile_cap=8, impl="pallas")):
        assert torch.equal(got[0], img) and torch.equal(got[1], idx)
    for mode in ("all", "first"):
        want = dibr_soft_mask(t["fvi"], idx, 700, 0.1, 5, knum_mode=mode)
        for got in (dibr_soft_mask(t["fvi"], idx, 700, 0.1, 5, 1000.0, 16,
                                   64, "xla", mode),
                    dibr_soft_mask(t["fvi"], idx, 700, 0.1, 5, tile_px=8,
                                   tile_cap=4, impl="pallas",
                                   knum_mode=mode)):
            assert torch.equal(got, want)
    want = dibr_rasterization(h, w, t["fvz"], t["fvi"], t["feats"], t["nz"],
                              700, 0.1)
    for got in (dibr_rasterization(h, w, t["fvz"], t["fvi"], t["feats"],
                                   t["nz"], 700, 0.1, 30, None, None, "brute",
                                   16, 64),
                dibr_rasterization(h, w, t["fvz"], t["fvi"], t["feats"],
                                   t["nz"], 700, 0.1, rast_backend="binned",
                                   tile_px=16, tile_cap=64)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_jax_style_values_are_checked_as_jax_checks_them():
    """F12: a binned search on an image that is not a whole number of
    tiles raises in both packages (tile_px 32 by default off a TPU); an
    unknown backend or impl name raises in the port."""
    t, h, w = _jax_style_case()
    args = (h, w, t["fvz"], t["fvi"], t["feats"])
    jargs = (h, w, *(jnp.asarray(x.numpy()) for x in args[2:]))
    for kw in ({"backend": "binned"}, {"backend": "binned", "tile_px": 20}):
        with pytest.raises(ValueError, match="divisible"):
            rasterize_jax(*jargs, **kw)
        with pytest.raises(ValueError, match="divisible"):
            rasterize(*args, **kw)
    for kw in ({"backend": "tiles"}, {"impl": "cuda"}):
        with pytest.raises(ValueError, match="unknown"):
            rasterize(*args, **kw)
    idx = torch.full((1, h, w), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown impl"):
        dibr_soft_mask(t["fvi"], idx, impl="triton")
    with pytest.raises(ValueError, match="unknown rast_backend"):
        dibr_rasterization(*args, t["nz"], rast_backend="dense")


def test_dibr_rasterization_and_mask_iou_match_jax():
    """The whole slice, forward and backward: dibr_rasterization (with a
    culled face and one with face_normals_z == 0) into mask_iou plus an
    image term; gradients with respect to face_vertices_image and features.
    Values against JAX dibr_rasterization; gradients against the same JAX
    composition with the binned soft mask holding every face."""
    rng = np.random.RandomState(3)
    b, f, h, w = 2, 40, 48, 40
    tri = (rng.randn(b, f, 3, 3) * 0.3).astype(np.float32)
    nz = rng.randn(b, f).astype(np.float32)
    nz[:, 0] = 0.0
    nz[:, 1] = -1.0
    data = {"fvz": tri[..., 2] - 2.0, "fvi": tri[..., :2],
            "feats": rng.rand(b, f, 3, 3).astype(np.float32), "nz": nz,
            "target": (rng.rand(b, h, w) > 0.5).astype(np.float32)}
    fvz, target = jnp.asarray(data["fvz"]), jnp.asarray(data["target"])

    img_j, soft_j, idx_j = dibr_rasterization_jax(
        h, w, fvz, jnp.asarray(data["fvi"]), jnp.asarray(data["feats"]),
        jnp.asarray(nz), sigmainv=700, boxlen=0.1)
    l_j = mask_iou_jax(soft_j, target) + jnp.mean(img_j)

    def loss_binned(fvi, feats):
        img, idx = rasterize_jax(h, w, fvz, fvi, feats,
                                 valid_faces=jnp.asarray(nz) >= 0)
        soft = jax.vmap(lambda v, s: _soft_mask_binned(
            v * 1000.0, s, 700.0, 0.1, 1000.0, h, w, tile_px=8, cap=f))(
                fvi, idx)
        return mask_iou_jax(soft, target) + jnp.mean(img)

    l_b, (gv_j, gf_j) = jax.value_and_grad(loss_binned, argnums=(0, 1))(
        jnp.asarray(data["fvi"]), jnp.asarray(data["feats"]))
    np.testing.assert_allclose(float(l_b), float(l_j), rtol=1e-6)

    t = from_numpy_tree(data, "cpu")
    fvi = t["fvi"].requires_grad_(True)
    feats = t["feats"].requires_grad_(True)
    img, soft, idx = dibr_rasterization(h, w, t["fvz"], fvi, feats, t["nz"],
                                        sigmainv=700, boxlen=0.1)
    loss = mask_iou(soft, t["target"]) + torch.mean(img)
    loss.backward()

    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               atol=1e-6)
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(soft_j),
                               atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    _assert_grads_close(fvi.grad.numpy(), np.asarray(gv_j))
    _assert_grads_close(feats.grad.numpy(), np.asarray(gf_j))


def test_unknown_knum_mode_raises():
    fvi = torch.from_numpy(random_faces(0, 3))
    with pytest.raises(ValueError, match="knum_mode"):
        dibr_soft_mask(fvi, torch.full((1, 8, 8), -1), knum_mode="last")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take only CUDA tensors; they never fall back."""
    fvi = torch.from_numpy(random_faces(0, 3)) * 1000.0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_soft_mask.soft_mask_fwd_cuda(fvi, 7000.0, 0.02, 1000.0, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_soft_mask.soft_mask_bwd_cuda(fvi, torch.zeros(1, 8, 8), 7000.0,
                                          0.02, 1000.0, 8, 8)
    assert profiling.counters()[cuda_soft_mask.FWD_LAUNCHES] == 0
    assert profiling.counters()[cuda_soft_mask.BWD_LAUNCHES] == 0


def test_soft_mask_fwd_cuda_refuses_bad_face_idx():
    """face_idx must be (B, H, W) int32, contiguous, on the faces' device:
    type, shape and device are checked before the faces' own checks, so
    each shows here on the CPU; a right face_idx beside CPU faces meets the
    wrapper's refusal of CPU tensors. Nothing launches."""
    fvi = torch.from_numpy(random_faces(0, 3)) * 1000.0
    good = torch.full((1, 8, 8), -1, dtype=torch.int32)
    fwd = cuda_soft_mask.soft_mask_fwd_cuda
    for bad, err, what in ((good.long(), TypeError, "int32"),
                           (good[:, :4], ValueError, "shape"),
                           (good.to("meta"), ValueError, "must be on"),
                           (good.transpose(1, 2), ValueError, "contiguous"),
                           (good, ValueError, "CUDA")):
        with pytest.raises(err, match=what):
            fwd(fvi, 7000.0, 0.02, 1000.0, 8, 8, face_idx=bad)
    counts = profiling.counters()
    assert counts[cuda_soft_mask.FWD_LAUNCHES] == 0
    assert counts[cuda_soft_mask.FWD_WITH_FACE_IDX] == 0


def test_build_lists_sources_and_needs_nvcc(monkeypatch, tmp_path):
    names = sorted(p.name for p in cuda_build.sources())
    assert names == ["gather.cu", "raster.cu", "rasterize.cu",
                     "regather.cu", "soft_mask.cu", "status.cu",
                     "texture.cu"]
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    path = cuda_build.library_path()
    assert path.parts[-4:-2] == ("build", "kaolin_tpu_torch")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_failed_build_leaves_no_objects(monkeypatch, tmp_path):
    """One source fails to compile while the others succeed: the build
    raises and removes every object file it wrote."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    # writes its -o file, then fails on raster.cu only
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  case "$1" in -o) shift; touch "$1";;\n'
                    '    *raster.cu) bad=1;; esac\n  shift\ndone\n'
                    'exit ${bad:-0}\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    so = tmp_path / "build" / "libkaolin_tpu_torch.so"
    monkeypatch.setattr(cuda_build, "library_path", lambda: so)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build()
    assert list(so.parent.iterdir()) == []


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_interop_round_trip(dtype):
    tree = {"a": np.arange(6).reshape(2, 3).astype(dtype),
            "b": [np.zeros((1, 4), dtype), (np.ones((2,), dtype),)]}
    out = from_numpy_tree(tree, "cpu")
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    for got, want in ((out["a"], tree["a"]), (out["b"][0], tree["b"][0]),
                      (out["b"][1][0], tree["b"][1][0])):
        assert got.device.type == "cpu" and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    tree["a"][0, 0] = 1
    assert out["a"][0, 0].item() == 0   # a copy, not a view


def test_import_leaves_out_jax_and_kaolin_tpu():
    """Every module of the port and every torch example imports, and the
    Newton example's and the torch recipes' bodies run on the CPU, with
    ``jax`` and ``kaolin_tpu`` blocked (an import of either raises), and
    neither is loaded afterwards; ``PIL`` is blocked too, so
    ``kaolin_tpu_torch.io`` and everything else import without Pillow;
    no import builds the native library or loads tornado."""
    code = ("import importlib.abc, sys\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'kaolin_tpu', 'PIL'):\n"
            "            raise ImportError(f'blocked: {name}')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import kaolin_tpu_torch.io, kaolin_tpu_torch.io.dataset, "
            "kaolin_tpu_torch.io.gltf, kaolin_tpu_torch.io.materials, "
            "kaolin_tpu_torch.io.obj, kaolin_tpu_torch.io.off, "
            "kaolin_tpu_torch.io.ply, kaolin_tpu_torch.io.utils, "
            "kaolin_tpu_torch.io.gaussians, "
            "kaolin_tpu_torch.io.mesh, kaolin_tpu_torch.io.render, "
            "kaolin_tpu_torch.io.shapenet, kaolin_tpu_torch.io.modelnet, "
            "kaolin_tpu_torch.io.shrec, kaolin_tpu_torch.ops.gcn, "
            "kaolin_tpu_torch.ops.random, kaolin_tpu_torch.ops.coords, "
            "kaolin_tpu_torch.ops.reduction, kaolin_tpu_torch.utils.testing, "
            "kaolin_tpu_torch.utils.env_vars, "
            "kaolin_tpu_torch.utils.bundled_data\n"
            "import kaolin_tpu_torch, kaolin_tpu_torch.render.mesh, "
            "kaolin_tpu_torch.metrics.render, kaolin_tpu_torch.ops.spc, "
            "kaolin_tpu_torch.render.camera, kaolin_tpu_torch.render.spc, "
            "kaolin_tpu_torch.render.spc.cuda_raster, "
            "kaolin_tpu_torch.utils.primitives_bench, "
            "kaolin_tpu_torch.utils.profiling, "
            "kaolin_tpu_torch.utils.cuda_gather, kaolin_tpu_torch.physics, "
            "kaolin_tpu_torch.physics.simplicits.simulation, "
            "kaolin_tpu_torch.physics.simplicits.rkpm, "
            "kaolin_tpu_torch.physics.simplicits.losses, "
            "kaolin_tpu_torch.ops.pointcloud, kaolin_tpu_torch.ops.mesh, "
            "kaolin_tpu_torch.ops.batch, kaolin_tpu_torch.ops.mesh.mesh, "
            "kaolin_tpu_torch.ops.mesh.trianglemesh, "
            "kaolin_tpu_torch.ops.mesh.tetmesh, "
            "kaolin_tpu_torch.metrics.trianglemesh, "
            "kaolin_tpu_torch.math.quat.util, "
            "kaolin_tpu_torch.math.quat.quaternion, "
            "kaolin_tpu_torch.math.quat.rotation33, "
            "kaolin_tpu_torch.math.quat.matrix44, "
            "kaolin_tpu_torch.math.quat.angle_axis, "
            "kaolin_tpu_torch.math.quat.euclidean, "
            "kaolin_tpu_torch.math.quat.transform, "
            "kaolin_tpu_torch.render.camera.legacy, "
            "kaolin_tpu_torch.render.camera.extrinsics_backends, "
            "kaolin_tpu_torch.render.camera.coordinates, "
            "kaolin_tpu_torch.render.camera.trajectory, "
            "kaolin_tpu_torch.render.mesh.utils, "
            "kaolin_tpu_torch.utils.numerics, "
            "kaolin_tpu_torch.ops.spc.exsum_compat, "
            "kaolin_tpu_torch.ops.spc.convolution, "
            "kaolin_tpu_torch.ops.spc.raytraced_spc_dataset, "
            "kaolin_tpu_torch.ops.conversions, kaolin_tpu_torch.rep, "
            "kaolin_tpu_torch.render.spc.raytrace, "
            "kaolin_tpu_torch.ops.conversions.flexicubes, "
            "kaolin_tpu_torch.ops.conversions.flexicubes.dense, "
            "kaolin_tpu_torch.ops.conversions.tetmesh, "
            "kaolin_tpu_torch.ops.conversions.sdf, "
            "kaolin_tpu_torch.ops.conversions.voxelgrid, "
            "kaolin_tpu_torch.ops.voxelgrid, kaolin_tpu_torch.non_commercial, "
            "kaolin_tpu_torch.metrics.pointcloud, "
            "kaolin_tpu_torch.metrics.tetmesh, "
            "kaolin_tpu_torch.metrics.voxelgrid, "
            "kaolin_tpu_torch.rep.gaussians, "
            "kaolin_tpu_torch.rep.tensor_container, "
            "kaolin_tpu_torch.ops.gaussians, "
            "kaolin_tpu_torch.ops.gaussians.densifier, "
            "kaolin_tpu_torch.ops.gaussians.transforms, "
            "kaolin_tpu_torch.ops.conversions.gaussians, "
            "kaolin_tpu_torch.ops.spc.bf_recon, "
            "kaolin_tpu_torch.render.camera.gsplats, "
            "kaolin_tpu_torch.render.camera.polyscope, "
            "kaolin_tpu_torch.rep.surface_mesh, kaolin_tpu_torch.utils.log, "
            "kaolin_tpu_torch.render.materials, "
            "kaolin_tpu_torch.render.lighting, "
            "kaolin_tpu_torch.render.lighting.sg, "
            "kaolin_tpu_torch.render.lighting.sh, "
            "kaolin_tpu_torch.render.easy_render, "
            "kaolin_tpu_torch.render.easy_render.common, "
            "kaolin_tpu_torch.render.easy_render.mesh, "
            "kaolin_tpu_torch.render.mesh.deftet, "
            "kaolin_tpu_torch.render.mesh.nvdiffrast_context, "
            "kaolin_tpu_torch.native, kaolin_tpu_torch.native.build, "
            "kaolin_tpu_torch.io.usd, kaolin_tpu_torch.io.usd.core, "
            "kaolin_tpu_torch.io.usd.crate, "
            "kaolin_tpu_torch.io.usd.crate_write, "
            "kaolin_tpu_torch.io.usd.materials, kaolin_tpu_torch.visualize, "
            "kaolin_tpu_torch.visualize.timelapse, "
            "kaolin_tpu_torch.visualize.ipython, "
            "kaolin_tpu_torch.experimental, "
            "kaolin_tpu_torch.experimental.dash3d, "
            "kaolin_tpu_torch.experimental.dash3d.util, "
            "kaolin_tpu_torch.experimental.dash3d.run, "
            "kaolin_tpu_torch.experimental.newton, "
            "kaolin_tpu_torch.experimental.newton.builder, "
            "kaolin_tpu_torch.experimental.newton.collisions, "
            "kaolin_tpu_torch.experimental.newton.model, "
            "kaolin_tpu_torch.experimental.newton.shapes, "
            "kaolin_tpu_torch.experimental.newton.solver, "
            "kaolin_tpu_torch.parallel, kaolin_tpu_torch.parallel.ops, "
            "kaolin_tpu_torch.parallel.simplicits, runpy\n"
            "for ex in ('torch_simplicits_drop', 'torch_simplicits_train', "
            "'torch_dibr_optimization', 'torch_dibr_texture_fit', "
            "'torch_tutorial_camera_rasterization', "
            "'torch_tutorial_bbox_fitting', 'torch_spc_raster', "
            "'torch_collision_stack', 'torch_spc_raytrace', "
            "'torch_tutorial_understanding_spcs', 'torch_flexicubes_sdf', "
            "'torch_tutorial_dmtet', 'torch_simulatable_gaussians', "
            "'torch_tutorial_working_with_gaussians', 'torch_easy_render', "
            "'torch_tutorial_easy_mesh_render', "
            "'torch_tutorial_diffuse_lighting', "
            "'torch_tutorial_sg_specular_lighting', 'torch_asset_render', "
            "'torch_tutorial_working_with_meshes', 'torch_usd_asset', "
            "'torch_tutorial_usd_scene', 'torch_newton_coupling'):\n"
            "    runpy.run_path(f'examples/{ex}.py')\n"
            "runpy.run_path('examples/torch_newton_coupling.py')['run']("
            "'cpu', 2, quiet=True)\n"
            "for r in ('quaternions', 'camera_recipes', 'mesh_sampling', "
            "'spc_basics', 'spc_from_pointcloud'):\n"
            "    runpy.run_path(f'examples/recipes/torch_{r}.py')['main']("
            "'cpu')\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kaolin_tpu', "
            "'PIL', 'tornado') or m.startswith(('jax.', 'kaolin_tpu.', "
            "'PIL.', 'tornado.'))]\n"
            "if kaolin_tpu_torch.native._LIB is not None:\n"
            "    bad.append('the native library, loaded at import')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
