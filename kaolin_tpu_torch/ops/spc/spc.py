"""SPC core: octree scanning, point generation, queries, duals and the
dense bridges.

Counterpart of ``kaolin_tpu/ops/spc/spc.py``. Layout: byte-packed
Morton-BFS octrees, pyramids (B, 2, max_level + 2) with per-level counts
and offsets, exsum the per-octree inclusive popcount sum. Scanning, point
generation and ``feature_grids_to_spc`` run on the host in numpy, as in the
JAX package (variable-length outputs, once per asset), and return tensors
on the octree's device. ``unbatched_query`` and ``to_dense`` are device
code. The dual octree and the trinkets, host numpy in the JAX package, are
integer work on the hierarchy's device here (``torch.unique`` and
``torch.searchsorted`` over Morton codes), equal to JAX's element for
element.
"""

import math

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import (
    device_of,
    host,
    morton_to_points,
    points_to_corners,
    points_to_morton,
    unbatched_points_to_octree,
)

__all__ = [
    "scan_octrees",
    "generate_points",
    "to_dense",
    "feature_grids_to_spc",
    "unbatched_query",
    "unbatched_get_level_points",
    "unbatched_make_dual",
    "unbatched_make_trinkets",
]

_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)],
                           dtype=np.int32)


def popcount_table(device):
    """The popcount of every byte, (256,) int32 on ``device``: torch has no
    popcount op, so a byte's count is a lookup."""
    return torch.from_numpy(_POPCOUNT_TABLE).to(device)


def _scan_single(octree_np):
    """One octree → (max_level, counts per level, exsum)."""
    popc = _POPCOUNT_TABLE[octree_np]
    exsum = np.cumsum(popc).astype(np.int32)
    counts = [1]
    consumed = 0
    while consumed < octree_np.shape[0]:
        n_bytes = counts[-1]
        counts.append(int(popc[consumed:consumed + n_bytes].sum()))
        consumed += n_bytes
    return len(counts) - 1, counts, exsum


def scan_octrees(octrees, lengths, legacy_exsum=False, device=None):
    """(packed uint8 octrees, lengths (B,)) → (max_level, pyramids
    (B, 2, max_level + 2) int32, exsum int32), scanned on the host and
    placed on ``device`` (``points.device_of``: else where the first
    tensor lies, else the card)."""
    octrees_np = host(octrees)
    lengths_np = host(lengths)
    offsets = np.concatenate([[0], np.cumsum(lengths_np)])
    results = [_scan_single(octrees_np[offsets[i]:offsets[i + 1]])
               for i in range(lengths_np.shape[0])]
    max_level = max(r[0] for r in results)
    pyramids = np.zeros((len(results), 2, max_level + 2), dtype=np.int32)
    exsums = []
    for i, (_, counts, exsum) in enumerate(results):
        counts = counts + [0] * (max_level + 1 - len(counts))
        pyramids[i, 0, :max_level + 1] = counts
        pyramids[i, 1, 1:] = np.cumsum(counts)
        exsums.append(np.concatenate([[0], exsum]) if legacy_exsum
                      else exsum)
    device = device_of(octrees, device, lengths)
    return (max_level, torch.from_numpy(pyramids).to(device),
            torch.from_numpy(np.concatenate(exsums).astype(np.int32)).to(
                device))


def generate_points(octrees, pyramids, exsum, device=None):
    """Decode octrees → packed point hierarchies (num_points, 3) int16,
    decoded on the host and placed as :func:`scan_octrees` places."""
    octrees_np = host(octrees)
    pyramids_np = host(pyramids)
    # bytes per octree = points up to level L - 1
    offsets = np.concatenate([[0], np.cumsum(pyramids_np[:, 1, -2])])
    corner_offs = np.stack([(np.arange(8) >> 2) & 1, (np.arange(8) >> 1) & 1,
                            np.arange(8) & 1], axis=-1)
    all_points = []
    for i in range(pyramids_np.shape[0]):
        bo = octrees_np[offsets[i]:offsets[i + 1]]
        cur = np.zeros((1, 3), dtype=np.int64)
        pts = [cur]
        consumed = 0
        while consumed < bo.shape[0]:
            n_bytes = cur.shape[0]
            bits = (bo[consumed:consumed + n_bytes, None]
                    >> np.arange(8)[None]) & 1                # (n, 8)
            par_idx, oct_idx = np.nonzero(bits)
            cur = cur[par_idx] * 2 + corner_offs[oct_idx]
            pts.append(cur)
            consumed += n_bytes
        all_points.append(np.concatenate(pts, axis=0))
    return torch.from_numpy(
        np.concatenate(all_points).astype(np.int16)).to(
            device_of(octrees, device, pyramids, exsum))


def unbatched_get_level_points(point_hierarchy, pyramid, level):
    """The points of one level of one octree."""
    pyramid = host(pyramid)
    start = int(pyramid[1, level])
    return point_hierarchy[start:start + int(pyramid[0, level])]


def unbatched_query(octree, exsum, query_coords, level, with_parents=False):
    """Walk the octree to the point-hierarchy indices of query coords; -1
    for empty space. Device code, no host read.

    query_coords: float (N, 3) in [-1, 1] or int (N, 3) in [0, 2^level).
    Returns (N,) int32, or (N, level + 1) with ``with_parents``: the index
    at every level from the root down.
    """
    if query_coords.is_floating_point():
        coords = torch.floor(torch.clamp(
            (query_coords + 1.0) * (2 ** level / 2.0), 0,
            2 ** level - 1)).to(torch.int32)
    else:
        coords = query_coords.to(torch.int32)
    popc = popcount_table(coords.device)
    exsum = exsum.to(torch.int32)
    n = coords.shape[0]
    ord_ = torch.zeros((n,), dtype=torch.int32, device=coords.device)
    alive = torch.all((coords >= 0) & (coords < 2 ** level), dim=-1)
    parents = [torch.where(alive, ord_, -1)]
    for lv in range(1, level + 1):
        shift = level - lv
        o = (((coords[:, 0] >> shift) & 1) * 4
             + ((coords[:, 1] >> shift) & 1) * 2
             + ((coords[:, 2] >> shift) & 1))
        byte = octree[ord_.long()].to(torch.int32)
        has_child = ((byte >> o) & 1) == 1
        below = byte & ((1 << o) - 1)
        base = torch.where(ord_ > 0, exsum[torch.clamp(ord_ - 1, min=0).long()],
                           0)
        child = base + popc[below.long()] + 1
        alive = alive & has_child
        ord_ = torch.where(alive, child, ord_)
        parents.append(torch.where(alive, ord_, -1))
    if with_parents:
        return torch.stack(parents, dim=-1)
    return torch.where(alive, ord_, -1)


def to_dense(point_hierarchies, pyramids, input, level=-1, **kwargs):
    """Scatter one level's features into dense grids (B, feature_dim, G, G,
    G), on ``input``'s device. Differentiable in ``input``."""
    pyramids_np = host(pyramids)
    if level < 0:
        level = pyramids_np.shape[2] - 1 + level
    g = 2 ** level
    b = pyramids_np.shape[0]
    batch_offsets = np.concatenate([[0], np.cumsum(pyramids_np[:, 1, -1])])
    out = input.new_zeros((b, g, g, g, input.shape[-1]))
    in_off = 0
    for i in range(b):
        start = int(batch_offsets[i] + pyramids_np[i, 1, level])
        num = int(pyramids_np[i, 0, level])
        pts = point_hierarchies[start:start + num].long()
        out = out.index_put((torch.full_like(pts[:, 0], i), pts[:, 0],
                             pts[:, 1], pts[:, 2]),
                            input[in_off:in_off + num])
        in_off += num
    return out.permute(0, 4, 1, 2, 3)


def feature_grids_to_spc(feature_grids, masks=None, device=None):
    """Dense (B, C, X, Y, Z) grids → (octrees, lengths, packed features),
    built on the host and placed as :func:`scan_octrees` places."""
    fg = host(feature_grids)
    b, c = fg.shape[:2]
    dims = fg.shape[2:]
    level = max(1, math.ceil(math.log2(max(dims))))
    g = 2 ** level
    padded = np.zeros((b, g, g, g, c), dtype=fg.dtype)
    padded[:, :dims[0], :dims[1], :dims[2]] = np.transpose(fg, (0, 2, 3, 4, 1))
    if masks is None:
        masks_np = np.any(padded != 0, axis=-1)
    else:
        masks_np = np.zeros((b, g, g, g), dtype=bool)
        masks_np[:, :dims[0], :dims[1], :dims[2]] = host(masks)
    octrees, lengths, feats = [], [], []
    for i in range(b):
        coords = np.stack(np.nonzero(masks_np[i]), axis=-1)
        if coords.shape[0] == 0:
            octrees.append(np.zeros((1,), dtype=np.uint8))
            lengths.append(1)
            continue
        octree = unbatched_points_to_octree(coords, level,
                                            device="cpu").numpy()
        octrees.append(octree)
        lengths.append(octree.shape[0])
        order = np.argsort(points_to_morton(coords, "cpu").numpy())
        feats.append(padded[i][tuple(coords[order].T)])
    features = (np.concatenate(feats, axis=0) if feats
                else np.zeros((0, c), dtype=fg.dtype))
    device = device_of(feature_grids, device, masks)
    return (torch.from_numpy(np.concatenate(octrees)).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device),
            torch.from_numpy(features).to(device))


def unbatched_make_dual(point_hierarchy, pyramid):
    """The dual octree: every level's unique cell corners in Morton order →
    (dual point hierarchy int16, dual pyramid (2, levels + 1) int32), on
    the hierarchy's device. A level-l corner reaches 2^l, which the Morton
    code's 16 bits a coordinate hold."""
    pyramid_np = host(pyramid)
    levels = pyramid_np.shape[1] - 1
    dual_points = []
    pyramid_dual = np.zeros_like(pyramid_np)
    for i in range(levels):
        pts = unbatched_get_level_points(point_hierarchy, pyramid_np, i)
        codes = torch.unique(points_to_morton(
            points_to_corners(pts).reshape(-1, 3)))
        dual_points.append(morton_to_points(codes))
        pyramid_dual[0, i] = codes.shape[0]
        if i > 0:
            pyramid_dual[1, i] = pyramid_dual[0, i - 1] + pyramid_dual[1, i - 1]
    pyramid_dual[1, levels] = (pyramid_dual[0, levels - 1]
                               + pyramid_dual[1, levels - 1])
    return (torch.cat(dual_points),
            torch.from_numpy(pyramid_dual).to(point_hierarchy.device))


def unbatched_make_trinkets(point_hierarchy, pyramid, point_hierarchy_dual,
                            pyramid_dual):
    """Each primary node's 8 dual (corner) indices and its parent's index
    → (trinkets (num_points, 8) int32, parents (num_points,) int32, -1 at
    the root), on the hierarchy's device."""
    pyramid_np = host(pyramid)
    pyramid_dual_np = host(pyramid_dual)
    levels = pyramid_np.shape[1] - 1
    trinkets, parents = [], []
    for lvl in range(levels):
        pts = unbatched_get_level_points(point_hierarchy, pyramid_np, lvl)
        dual_m = points_to_morton(unbatched_get_level_points(
            point_hierarchy_dual, pyramid_dual_np, lvl))
        corner_m = points_to_morton(points_to_corners(pts).reshape(-1, 3))
        idx = torch.searchsorted(dual_m, corner_m)
        trinkets.append(idx.reshape(-1, 8) + int(pyramid_dual_np[1, lvl]))
        if lvl == 0:
            parents.append(torch.full((pts.shape[0],), -1, dtype=torch.int64,
                                      device=pts.device))
        else:
            prev_m = points_to_morton(unbatched_get_level_points(
                point_hierarchy, pyramid_np, lvl - 1))
            parents.append(torch.searchsorted(prev_m,
                                              points_to_morton(pts // 2))
                           + int(pyramid_np[1, lvl - 1]))
    return (torch.cat(trinkets).to(torch.int32),
            torch.cat(parents).to(torch.int32))
