"""Tile-binned first-hit rasterizer for Structured Point Clouds.

Counterpart of ``kaolin_tpu/render/spc/raster.py``. A first-hit depth and
point-hierarchy id image of one SPC level, in three steps:

1.  **Unit packing** (:func:`build_raster_spc`, once per octree, on the
    host in numpy): the level's leaves are ordered by recursive median cut
    and chunked into units of 128, so every unit's box is tight. A unit is
    one (8, 128) float32 block of per-leaf box bounds; row 6 carries the
    leaf's point-hierarchy id bit-cast to float32. The occupied level-3
    cells ride along for per-ray scene-exit bounds.
2.  **Binning** (:func:`_bin_units`, per frame, plain PyTorch): every unit
    box is projected through the camera to a conservative screen-tile span
    and expanded into (tile, quantized depth) slots; one stable sort and a
    segment rank build each tile's front-to-back unit table
    ``tab (c_cap, T)``, packed ``uid << 16 | zq``.
3.  **The tile kernel** (``csrc/raster.cu``, plain version
    :func:`raster_tiles_plain`): per tile, pinhole rays from the camera
    vector, a slab test of the leaves of the tile's units front to back,
    and an early stop once every pixel's ``min(best hit, scene-exit
    bound)`` is nearer than the next batch's depth lower bound. The kernel
    skips a unit's leaves for a warp of 8 pixels when none of their rays
    enters the unit's box (``uaabb``) nearer than its best, which changes
    no result; the plain version tests every leaf. A second
    kernel (plain version :func:`untile_plain`) moves the tile-packed
    images to row-major order.

A CUDA tensor launches the kernels, a CPU tensor takes their plain versions.
The ray and slab arithmetic of both repeats the TPU kernel's op for op, so
their depths agree bit for bit; the ray origin, a per-frame constant, comes
in with the camera vector.

Two repairs against the JAX package: the slot split ``side_x`` follows
``s_max`` with no cap of 4 x-tiles, so a unit binned to the whole screen
fits once ``s_max >= tiles``; and more than 32,768 units or tiles, whose
ids would overflow the packed int32 key, raise instead of wrapping.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import device_of, host
from kaolin_tpu_torch.render.camera.intrinsics import CameraFOV
from kaolin_tpu_torch.render.spc import cuda_raster
from kaolin_tpu_torch.utils.backend import is_cuda

__all__ = ["RasterSPC", "build_raster_spc", "raster_first_hit",
           "raster_first_hit_sequence", "raster_tiles_plain", "untile_plain"]

_LANES = 128
_BIG = 3.0e38
_INT_BIG = 2 ** 30
# unit and tile ids ride in the upper 16 bits of an int32 key (id << 16 | zq)
_MAX_IDS = 2 ** 15
_NO_KEY = 0x7FFFFFFF


class RasterSPC(NamedTuple):
    """Camera-independent rasterization payload of one SPC level.

    units:   (U, 8, 128) float32: rows 0-2 leaf box min xyz, rows 3-5 box
             max xyz (world coords, the [-1, 1] cube), row 6 the leaf's
             int32 point-hierarchy id bit-cast to float32, row 7 zero. Dead
             lanes past the last leaf carry mins of 3e38 and never hit.
    uids:    (U, 128) int32 point-hierarchy id of each lane, -1 when dead.
    uaabb:   (U, 8) float32 tight unit box (min xyz, max xyz, 0, 0).
    l3boxes: (M, 8) float32 occupied level-3 cells (min xyz, max xyz),
             M a multiple of 8 and at most 512; padding rows have
             min 2e38 > max -2e38.
    level:   the octree level rasterized.
    """

    units: torch.Tensor
    uids: torch.Tensor
    uaabb: torch.Tensor
    l3boxes: torch.Tensor
    level: int


def _median_cut_order(leaves):
    """Recursive median cut into tight chunks of 128 leaves: split the
    widest axis at a 128-aligned median and recurse."""
    out = []

    def rec(ids):
        if len(ids) <= _LANES:
            out.append(ids)
            return
        pts = leaves[ids]
        ax = int(np.argmax(pts.max(0) - pts.min(0)))
        half = (len(ids) // 2 + _LANES - 1) // _LANES * _LANES
        if half >= len(ids):
            half = _LANES * (max(1, len(ids) // _LANES // 2))
        srt = ids[np.argsort(pts[:, ax], kind="stable")]
        rec(srt[:half])
        rec(srt[half:])

    rec(np.arange(len(leaves), dtype=np.int64))
    return np.concatenate(out)


def build_raster_spc(point_hierarchy, pyramid, level, device=None):
    """Pack the level-``level`` leaves of an SPC into rasterization units.

    On the host, once per octree. ``uids`` keeps each lane's original
    point-hierarchy index, so results are those of the Morton-order
    traversal. The tensors go to ``device``, else to the device of
    ``point_hierarchy`` or ``pyramid`` when one is a tensor, else to the
    card."""
    device = device_of(point_hierarchy, device, pyramid)
    pyramid = host(pyramid)
    start = int(pyramid[1, level])
    num = int(pyramid[0, level])
    leaves = host(point_hierarchy)[start:start + num].astype(np.int64)
    cellw = 2.0 / (2 ** level)
    perm = _median_cut_order(leaves) if num else np.zeros(0, np.int64)
    leaves = leaves[perm]

    u = max(1, (num + _LANES - 1) // _LANES)
    qpad = u * _LANES
    bmin = leaves.astype(np.float64) * cellw - 1.0           # (Q, 3)
    rows = np.full((qpad, 8), 3.0e38, np.float32)
    rows[:num, 0:3] = bmin
    rows[:num, 3:6] = bmin + cellw
    rows[:, 6:8] = 0.0
    uids = np.full((qpad,), -1, np.int32)
    uids[:num] = (start + perm).astype(np.int32)
    rows[:, 6] = uids.view(np.float32)
    units = np.ascontiguousarray(
        rows.reshape(u, _LANES, 8).transpose(0, 2, 1))        # (U, 8, 128)

    uaabb = np.zeros((u, 8), np.float32)
    r3 = (rows[:, 0] < 1.0e38).reshape(u, _LANES)
    per_lane = rows.reshape(u, _LANES, 8)
    uaabb[:, 0:3] = np.where(r3[..., None], per_lane[..., 0:3],
                             np.inf).min(axis=1)
    uaabb[:, 3:6] = np.where(r3[..., None], per_lane[..., 3:6],
                             -np.inf).max(axis=1)
    # a fully dead unit (only when num == 0) gets a degenerate box
    dead_u = ~r3.any(axis=1)
    uaabb[dead_u, 0:6] = 2.0e38

    # occupied level-3 cells: every leaf lies in one, so a ray's last exit
    # from them bounds any hit depth from above
    l3 = np.unique(leaves >> (level - 3), axis=0) if num else \
        np.zeros((0, 3), np.int64)
    w3 = 2.0 / 8.0
    m2 = max(8, int(np.ceil(max(len(l3), 1) / 8.0)) * 8)
    boxes = np.full((m2, 8), 2.0e38, np.float32)
    boxes[:len(l3), 0:3] = l3 * w3 - 1.0
    boxes[:len(l3), 3:6] = l3 * w3 - 1.0 + w3
    boxes[len(l3):, 3:6] = -2.0e38        # min > max: never intersected

    def put(a):
        return torch.from_numpy(a).to(device)

    return RasterSPC(units=put(units), uids=put(uids.reshape(u, _LANES)),
                     uaabb=put(uaabb), l3boxes=put(boxes), level=level)


# ---------------------------------------------------------------------------
# per-frame binning (plain PyTorch)
# ---------------------------------------------------------------------------

def _side_x(s_max, tx_n):
    """Columns of the ``s_max`` expansion slots: the largest divisor of
    ``s_max`` that is at most ``min(tx_n, ceil(sqrt(s_max)))``. Where
    ``s_max`` and the tile counts are powers of two, a span of every tile
    fits once ``s_max >= tx_n * ty_n``."""
    side = min(tx_n, math.isqrt(s_max - 1) + 1)
    while s_max % side:
        side -= 1
    return side


def _to_i32(x):
    """float32 → int32, truncating and saturating as XLA converts (torch's
    CPU conversion wraps out-of-range values instead)."""
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int32)


def _bin_units(uaabb, cam_r, cam_t, tan_h, tan_v, x0, y0, *, width, height,
               tile_h, tile_w, s_max, c_cap):
    """Project unit boxes → per-tile, front-to-back unit tables.

    Tiles are ``(tile_h, tile_w)`` pixel blocks, numbered row by row. The
    ``s_max`` expansion slots of a unit cover ``side_x`` tile columns times
    ``s_max // side_x`` tile rows of its span.

    Returns (tab (c_cap, T) int32 packed ``uid << 16 | zq``, counts (T,)
    int32, dz 0-dim float32, {"slot_overflow", "cap_overflow"} 0-dim
    int32). Conservative: a unit straddling the eye plane is binned to
    every tile; pixel boxes carry a margin of half a pixel plus 0.01.
    """
    u = uaabb.shape[0]
    tx_n = width // tile_w
    ty_n = height // tile_h
    t_n = tx_n * ty_n
    if u > _MAX_IDS or t_n > _MAX_IDS:
        raise ValueError(
            f"{u} units and {t_n} tiles: at most {_MAX_IDS} of each fit "
            "the packed int32 table")
    if s_max < 1 or c_cap < 1:
        raise ValueError(f"s_max and c_cap must be positive, got {s_max}, "
                         f"{c_cap}")
    side_x = _side_x(s_max, tx_n)
    side_y = s_max // side_x
    dev = uaabb.device
    f32 = torch.float32

    lo = uaabb[:, 0:3]
    hi = uaabb[:, 3:6]
    sel = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=f32, device=dev)                                # (8, 3)
    corners = lo[:, None, :] * (1.0 - sel) + hi[:, None, :] * sel  # (U,8,3)
    cam = torch.einsum("ij,ucj->uci", cam_r, corners) + cam_t     # (U,8,3)
    depth = -cam[..., 2]                                          # (U, 8)
    front = depth > 1e-8
    any_front = front.any(dim=1)
    straddle = any_front & ~front.all(dim=1)

    safe_d = torch.where(front, depth, 1.0)
    ndc_x = (cam[..., 0] / safe_d) / tan_h
    ndc_y = -(cam[..., 1] / safe_d) / tan_v
    px = (ndc_x + 1.0) * (width * 0.5) + x0                       # (U, 8)
    py = (ndc_y + 1.0) * (height * 0.5) - y0
    px_lo = torch.where(front, px, _BIG).amin(dim=1)
    px_hi = torch.where(front, px, -_BIG).amax(dim=1)
    py_lo = torch.where(front, py, _BIG).amin(dim=1)
    py_hi = torch.where(front, py, -_BIG).amax(dim=1)

    # pixel-centre convention: pixel index i sees continuous coord i + 0.5
    eps = 0.51
    ix0 = torch.where(straddle, 0, _to_i32(torch.ceil(px_lo - 0.5 - eps)))
    iy0 = torch.where(straddle, 0, _to_i32(torch.ceil(py_lo - 0.5 - eps)))
    ix1 = torch.where(straddle, width - 1,
                      _to_i32(torch.floor(px_hi - 0.5 + eps)))
    iy1 = torch.where(straddle, height - 1,
                      _to_i32(torch.floor(py_hi - 0.5 + eps)))
    onscreen = (ix1 >= 0) & (ix0 <= width - 1) & (iy1 >= 0) & \
        (iy0 <= height - 1)
    live = any_front & onscreen & (uaabb[:, 0] < 1.0e38)
    tx0 = ix0.clamp(0, width - 1) // tile_w
    tx1 = ix1.clamp(0, width - 1) // tile_w
    ty0 = iy0.clamp(0, height - 1) // tile_h
    ty1 = iy1.clamp(0, height - 1) // tile_h
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    slot_overflow = (live & ((span_x > side_x) | (span_y > side_y))).sum(
        dtype=torch.int32)

    zmin = torch.clamp_min(depth.amin(dim=1), 0.0)
    zmin = torch.where(straddle, 0.0, zmin)
    zmax_all = torch.where(live, zmin, 0.0).amax()
    # a 0-dim tensor divisor: CUDA divides by a Python number through its
    # reciprocal, which would round dz differently
    dz = (zmax_all + 1.0) / torch.full((), 65534.0, dtype=f32, device=dev)
    zq = torch.clamp(zmin / dz, 0, 65534).to(torch.int32)   # floor → bound

    iota_u = torch.arange(u, dtype=torch.int32, device=dev)
    s = torch.arange(s_max, dtype=torch.int32, device=dev)
    dx, dy = s % side_x, s // side_x                          # (S,)
    tile = (ty0[:, None] + dy[None]) * tx_n + (tx0[:, None] + dx[None])
    ok = (live[:, None] & (dx[None] < span_x[:, None])
          & (dy[None] < span_y[:, None]))
    key = torch.where(ok, (tile << 16) | zq[:, None], _NO_KEY).reshape(-1)
    val = ((iota_u << 16) | zq)[:, None].expand(u, s_max).reshape(-1)
    key_s, order = torch.sort(key, stable=True)
    val_s = val[order]

    iota = torch.arange(key.shape[0], dtype=torch.int32, device=dev)
    tile_s = key_s >> 16
    valid_s = key_s != _NO_KEY
    seg_start = torch.ones_like(valid_s)
    seg_start[1:] = tile_s[1:] != tile_s[:-1]
    run_first = torch.cummax(torch.where(seg_start, iota, 0), dim=0).values
    rank = iota - run_first

    counts = torch.zeros(t_n, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(valid_s, tile_s, 0).long(), valid_s.to(torch.int32))
    cap_overflow = (valid_s & (rank >= c_cap)).sum(dtype=torch.int32)

    # entries that do not fit go to one extra slot, cut off after
    keep = valid_s & (rank < c_cap)
    dest = torch.where(keep, rank * t_n + tile_s, c_cap * t_n)
    tab = torch.zeros(c_cap * t_n + 1, dtype=torch.int32, device=dev)
    tab.index_put_((dest.long(),), val_s)
    return (tab[:-1].view(c_cap, t_n), torch.clamp_max(counts, c_cap), dz,
            {"slot_overflow": slot_overflow, "cap_overflow": cap_overflow})


# ---------------------------------------------------------------------------
# plain versions of the CUDA kernels
# ---------------------------------------------------------------------------

def _rays(cam, row, col, width, height):
    """Pinhole rays through the centres of pixels (row, col), op for op as
    the CUDA kernel and the TPU kernel build them.

    ``cam`` is the camera vector of :func:`_camera_vector`. Returns (origin
    (ox, oy, oz), inverse direction (ix, iy, iz)): the origin 0-dim, the
    inverse direction shaped as ``row``. A direction component smaller than
    1e-12 is replaced by ±1e-12."""
    r = cam[0:9]
    tan_h, tan_v, x0, y0 = cam[12], cam[13], cam[14], cam[15]
    # divide by 0-dim tensors: a true division on every device
    w = torch.full((), float(width), dtype=cam.dtype, device=cam.device)
    h = torch.full((), float(height), dtype=cam.dtype, device=cam.device)
    pix_x = col.to(cam.dtype) + 0.5
    pix_y = row.to(cam.dtype) + 0.5
    pix_x = pix_x - x0
    pix_y = pix_y + y0
    ndc_x = 2 * (pix_x / w) - 1.0
    ndc_y = 2 * (pix_y / h) - 1.0
    dcx = ndc_x * tan_h
    dcy = -ndc_y * tan_v
    dw = [r[k] * dcx + r[3 + k] * dcy + r[6 + k] * (-1.0) for k in range(3)]
    nrm = torch.sqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    inv = []
    for d in dw:
        d = d / nrm
        inv.append(1.0 / torch.where(d.abs() > 1e-12, d,
                                     torch.where(d >= 0, 1e-12, -1e-12)))
    return [cam[16], cam[17], cam[18]], inv


def _slab(lo, hi, origin, inv):
    """Ray-box slab test, op for op as the traversal's: lo, hi, origin and
    inv are xyz triples of broadcastable tensors → (t_in, t_out, hit)."""
    t0 = [(lo[k] - origin[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - origin[k]) * inv[k] for k in range(3)]
    t_in = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                       torch.minimum(t0[1], t1[1])),
                         torch.minimum(t0[2], t1[2]))
    t_out = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                        torch.maximum(t0[1], t1[1])),
                          torch.maximum(t0[2], t1[2]))
    return t_in, t_out, t_out >= torch.clamp_min(t_in, 0.0)


def _exit_bound(l3boxes, origin, inv):
    """Per ray: the last exit from the occupied level-3 cells, -1 for a ray
    that misses them all. Rays (T, P), in chunks of tiles."""
    m = l3boxes.shape[0]
    t_n, p = inv[0].shape
    live = l3boxes[:, 0] < 1.0e38
    lo = [l3boxes[:, k] for k in range(3)]
    hi = [l3boxes[:, 3 + k] for k in range(3)]
    step = max(1, 2 ** 24 // (p * m))
    out = []
    for s in range(0, t_n, step):
        _, t_out, hit = _slab(lo, hi, origin,
                              [i[s:s + step, :, None] for i in inv])
        out.append(torch.where(hit & live, t_out, -1.0).amax(dim=-1))
    return torch.cat(out)


def raster_tiles_plain(tab, counts, dz, cam, l3boxes, units, uaabb, *,
                       width, height, tile_px, work=None):
    """Plain version of the tile kernel → (depth (T, P) float32, id (T, P)
    int32), 3e38 and -1 where no leaf is hit.

    Vectorised over tiles, slot after slot. Slots are taken in batches of
    4, 2 or 1 (the largest that divides ``c_cap``); after each batch a
    tile stops once ``max over its pixels of min(best, exit bound)`` is
    below the next batch's depth lower bound ``zq * dz``, and a stopped
    tile ignores later slots. Within a unit ties go to the lowest id;
    across units only a strictly nearer hit replaces the best, so the unit
    visited first wins. ``uaabb`` (U, 8), the tight unit boxes, is read
    only to count work.

    ``work``, a dict when given, gets counts of the walk up to each tile's
    early stop: ``"slab_tests"``, the (pixel, leaf) slab tests of every
    leaf of every unit walked; ``"unit_tests"``, the (pixel, unit-box)
    tests; and ``"needed_leaf_tests"``, 128 for each (pixel, unit) whose
    box the pixel's ray enters nearer than its best so far, the only units
    whose leaves can change a pixel. The results do not change."""
    c_cap, t_n = tab.shape
    tx_n = width // tile_px
    p = tile_px * tile_px
    dev = units.device
    batch = next(b for b in (4, 2, 1) if c_cap % b == 0)
    t_idx = torch.arange(t_n, device=dev)[:, None]
    si = torch.arange(p, device=dev)[None]
    origin, inv = _rays(cam, (t_idx // tx_n) * tile_px + si // tile_px,
                        (t_idx % tx_n) * tile_px + si % tile_px, width,
                        height)
    bound = _exit_bound(l3boxes, origin, inv)                 # (T, P)
    ids = units[:, 6].view(torch.int32)                       # (U, 128)
    if work is not None:
        for key in ("slab_tests", "unit_tests", "needed_leaf_tests"):
            work.setdefault(key, 0)

    best = torch.full((t_n, p), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((t_n, p), -1, dtype=torch.int32, device=dev)
    live = counts > 0
    for base in range(0, c_cap, batch):
        for s in range(base, base + batch):
            rows = torch.nonzero(live & (s < counts)).squeeze(1)
            if rows.numel() == 0:
                break
            uid = tab[s, rows] >> 16
            if work is not None:
                box = uaabb[uid][:, :, None]                  # (R, 8, 1)
                t_box, _, hit_box = _slab(
                    [box[:, k] for k in range(3)],
                    [box[:, 3 + k] for k in range(3)], origin,
                    [i[rows] for i in inv])
                work["slab_tests"] += rows.numel() * p * _LANES
                work["unit_tests"] += rows.numel() * p
                work["needed_leaf_tests"] += _LANES * int(
                    (hit_box & (t_box < best[rows])).sum())
            u = units[uid][:, :, None, :]                     # (R, 8, 1, 128)
            t_in, _, hit = _slab([u[:, k] for k in range(3)],
                                 [u[:, 3 + k] for k in range(3)], origin,
                                 [i[rows, :, None] for i in inv])
            cand = torch.where(hit, t_in, _BIG)               # (R, P, 128)
            m = cand.amin(dim=-1)
            sel = torch.where(cand == m[..., None], ids[uid][:, None, :],
                              _INT_BIG).amin(dim=-1)
            take = m < best[rows]
            best[rows] = torch.where(take, m, best[rows])
            best_id[rows] = torch.where(take, sel, best_id[rows])
        nxt = base + batch
        z_lb = (tab[min(nxt, c_cap - 1)] & 0xFFFF).to(torch.float32) * dz
        worst = torch.minimum(best, bound).amax(dim=1)
        live = live & (nxt < counts) & ~(worst < z_lb)
        if not bool(live.any()):
            break
    return best, best_id


def untile_plain(depth_t, hit_id, *, height, width, tile_px):
    """Plain version of the untile kernel: tile-packed (T, P) images →
    row-major (H·W,)."""
    ty_n, tx_n = height // tile_px, width // tile_px

    def rowmajor(x):
        return x.reshape(ty_n, tx_n, tile_px, tile_px).permute(
            0, 2, 1, 3).reshape(height * width)

    return rowmajor(depth_t), rowmajor(hit_id)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """a·b + c rounded once to float32, as a fused multiply-add. Computed
    in float64, where the product is exact; the sum is rounded twice, which
    differs from one rounding only at rare ties."""
    return (a.double() * b.double() + c.double()).float()


def ray_origin(cam_r, cam_t):
    """A pinhole camera's ray origin −Rᵀt, (3,) float32, as the JAX
    package's rays start: with fused multiply-adds where XLA's CPU backend
    contracts its ``r0·(0 − t0) + r1·(0 − t1) + r2·(0 − t2)``. Rays from
    it start at the same float in both packages, so their traversals agree
    bit for bit at most pixels."""
    r = cam_r.reshape(9).to(torch.float32)
    neg = 0.0 - cam_t.reshape(3).to(torch.float32)
    return torch.stack([_fma(r[6 + k], neg[2],
                             _fma(r[k], neg[0], r[3 + k] * neg[1]))
                        for k in range(3)])


def lookat_ray_origin(cam_r, eye):
    """The ray origin of a look-at camera at ``eye`` with rotation
    ``cam_r``, (3,) float32, as the JAX package's rays start: XLA's CPU
    backend contracts both the translation t = −R·eye and the origin
    −Rᵀ(0 − t) into fused multiply-adds, taken here in its order.
    ``generate_rays`` rounds each product on its own, as the camera's
    matrices are written; an origin 1 ulp off moves grazing rays across
    cell faces, so a traversal held to the JAX package's nuggets starts its
    rays here."""
    r = cam_r.reshape(3, 3).to(torch.float32)
    eye = eye.reshape(3).to(torch.float32)
    t = -torch.stack([_fma(r[i, 2], eye[2], _fma(r[i, 1], eye[1],
                                                  r[i, 0] * eye[0]))
                      for i in range(3)])
    return ray_origin(r, t)


def _camera_vector(cam_r, cam_t, tan_h, tan_v, x0, y0):
    """The (19,) float32 camera vector of the tile kernel: R row-major, t,
    tan_h, tan_v, x0, y0 and the ray origin (:func:`ray_origin`), computed
    once per frame."""
    return torch.cat([cam_r.reshape(9).to(torch.float32),
                      cam_t.reshape(3).to(torch.float32),
                      torch.stack([tan_h, tan_v, x0, y0]).to(torch.float32),
                      ray_origin(cam_r, cam_t)])


def _finish(depth, nidx, overflow):
    valid = depth < 1.0e38
    return torch.where(valid, depth, torch.inf), nidx, valid, overflow


def kernel_tile(tile_px):
    """The tile side the raster bins and renders at for a requested
    ``tile_px``: itself up to ``cuda_raster.MAX_TILE_PX`` (16), above that
    the largest divisor of it that is at most 16 (32 → 16, 24 → 12, 20 →
    10). Every tile the JAX package takes, one that divides the image,
    stays a whole number of these, and the frame is the one rendered at
    the smaller tile, on the CPU and on the card alike; the overflow counts
    are those of the smaller tiles."""
    if tile_px <= cuda_raster.MAX_TILE_PX:
        return tile_px
    return max(d for d in range(1, cuda_raster.MAX_TILE_PX + 1)
               if tile_px % d == 0)


def _raster_frame(units, uaabb, l3boxes, cam_r, cam_t, tan_h, tan_v, x0, y0,
                  *, width, height, tile_px, s_max, c_cap):
    if tile_px < 1 or width % tile_px or height % tile_px:
        raise ValueError(f"{width}x{height} is not a whole number of "
                         f"{tile_px}-pixel tiles")
    tile_px = kernel_tile(tile_px)
    tab, counts, dz, overflow = _bin_units(
        uaabb, cam_r, cam_t, tan_h, tan_v, x0, y0, width=width,
        height=height, tile_h=tile_px, tile_w=tile_px, s_max=s_max,
        c_cap=c_cap)
    cam = _camera_vector(cam_r, cam_t, tan_h, tan_v, x0, y0)
    size = dict(height=height, width=width, tile_px=tile_px)
    if is_cuda(units):
        depth_t, hit_id = cuda_raster.raster_tiles_cuda(
            tab, counts, dz, cam, l3boxes, units, uaabb, **size)
        depth, nidx = cuda_raster.untile_cuda(depth_t, hit_id, **size)
    else:
        depth_t, hit_id = raster_tiles_plain(tab, counts, dz, cam, l3boxes,
                                             units, uaabb, **size)
        depth, nidx = untile_plain(depth_t, hit_id, **size)
    return _finish(depth, nidx, overflow)


def _prep_camera(camera):
    """Per-frame camera scalars: (R (3, 3), t (3,), tan_h, tan_v, x0, y0),
    float32."""
    f32 = torch.float32
    return (camera.extrinsics.R[0].to(f32),
            camera.extrinsics.t[0, :, 0].to(f32),
            camera.intrinsics.tan_half_fov(CameraFOV.HORIZONTAL).to(
                f32).reshape(()),
            camera.intrinsics.tan_half_fov(CameraFOV.VERTICAL).to(
                f32).reshape(()),
            camera.x0.to(f32).reshape(()), camera.y0.to(f32).reshape(()))


def _check_pinhole(camera):
    if camera.lens_type != "pinhole":
        raise ValueError("the SPC raster needs a pinhole camera, got "
                         f"{camera.lens_type!r}")


def raster_first_hit(rspc, camera, *, tile_px=16, s_max=16, c_cap=32):
    """First-hit depth and id image of an SPC level through ``camera``.

    Returns ``(t (H·W,), nidx (H·W,), valid (H·W,), overflow)`` in the
    row-major ray order of :func:`generate_rays`: ``t`` is the slab entry
    depth of the nearest leaf hit (inf on a miss), ``nidx`` its
    point-hierarchy index (-1 on a miss). ``overflow`` holds the binning
    capacity counts ``slot_overflow`` and ``cap_overflow``, 0-dim int32
    tensors: nonzero means grow ``s_max`` / ``c_cap`` and render again,
    since leaves may be missed until then. ``tile_px`` may be any tile side
    that divides the image; one above 16 is split into the tiles of
    :func:`kernel_tile` on every device. Pinhole cameras only.
    """
    _check_pinhole(camera)
    return _raster_frame(
        rspc.units, rspc.uaabb, rspc.l3boxes, *_prep_camera(camera),
        width=int(camera.width), height=int(camera.height), tile_px=tile_px,
        s_max=s_max, c_cap=c_cap)


def raster_first_hit_sequence(rspc, cameras, *, tile_px=16, s_max=16,
                              c_cap=32):
    """Render a trajectory of pinhole cameras of one image size, frame
    after frame.

    Returns ``(t (F, H·W), nidx (F, H·W), valid (F, H·W), overflow)``
    with the overflow counts summed over the frames."""
    width, height = int(cameras[0].width), int(cameras[0].height)
    for c in cameras:
        _check_pinhole(c)
        if (int(c.width), int(c.height)) != (width, height):
            raise ValueError("all cameras of a sequence need one image size")
    frames = [_raster_frame(rspc.units, rspc.uaabb, rspc.l3boxes,
                            *_prep_camera(c), width=width, height=height,
                            tile_px=tile_px, s_max=s_max, c_cap=c_cap)
              for c in cameras]
    t, nidx, valid = (torch.stack([f[i] for f in frames]) for i in range(3))
    overflow = {k: torch.stack([f[3][k] for f in frames]).sum(
        dtype=torch.int32) for k in frames[0][3]}
    return t, nidx, valid, overflow
