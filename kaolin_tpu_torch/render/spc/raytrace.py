"""SPC octree raytracing and packed ray operations.

Counterpart of ``kaolin_tpu/render/spc/raytrace.py``, plain PyTorch: the
JAX module is jitted XLA with no Pallas kernel. Three breadth-first
traversals, each expanding active (ray, node) pairs level by level into
their children in per-ray front-to-back octant order (``child = v XOR
neg``) and compacting them in order, so nuggets come out ray-major and
depth-sorted per ray, element for element as JAX's:

- ``_raytrace_frontier``: one global frontier of ``capacity`` slots,
  compacted each level by an exclusive count and one token scatter (the
  default path of ``unbatched_raytrace``);
- ``_raytrace_perray``: ``slots`` slots a ray, compacted within each row
  (level > 10 or huge octrees);
- ``_raytrace_fixed``: an explicit capacity, compacted by a cumsum rank (the
  ``max_nuggets`` path and ``raytrace_overflow_report``).

None reads the device from the host inside its level loop: overflow and
counts stay tensors, and ``unbatched_raytrace`` reads the overflow flag and
the nugget count once a call, as JAX does. The slab test is JAX's:
subtract, then multiply by the inverse direction, min/max, from integer
cell coords times powers of two, so t_in/t_out equal JAX's on the same
rays.

The packed ray ops are segment operations over boundary masks:
``index_add_``/``scatter_reduce`` for the reductions and a flagged
Hillis–Steele scan for ``cumsum``/``cumprod``, all differentiable by
autograd. The scan restarts at each pack, as JAX's associative scan does,
and needs no division, so ``cumprod`` takes zeros.
"""

import warnings

import torch

from kaolin_tpu_torch.ops.spc.spc import popcount_table
from kaolin_tpu_torch.ops.spc.points import host

__all__ = [
    "unbatched_raytrace",
    "raytrace_overflow_report",
    "mark_pack_boundaries",
    "diff",
    "sum_reduce",
    "prod_reduce",
    "cumsum",
    "cumprod",
    "exponential_integration",
    "mark_first_hit",
]

_I32 = torch.int32
# a node record ``prev_exsum << 8 | byte`` fits int32 while 8 x the octree's
# bytes stays below this
_NODE_TABLE_LIMIT = 1 << 23


# ---------------------------------------------------------------------------
# raytracing
# ---------------------------------------------------------------------------

def _inv_dir(direction):
    tiny = torch.where(direction >= 0, 1e-12, -1e-12).to(direction.dtype)
    return 1.0 / torch.where(direction.abs() > 1e-12, direction, tiny)


def _neg_mask(direction):
    """Per-ray octant visit mask: bits set where the direction is negative
    along (x, y, z)."""
    neg = (direction < 0).to(_I32)
    return neg[:, 0] * 4 + neg[:, 1] * 2 + neg[:, 2]


def _ray_aabb(origin, inv_dir, bmin, bmax):
    """Slab test over the last axis → (hit, t_entry, t_exit)."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmax >= torch.clamp(tmin, min=0.0), tmin, tmax


def _octant_bits(child):
    """(...,) octant → (..., 3) offsets (x, y, z)."""
    return torch.stack([(child >> 2) & 1, (child >> 1) & 1, child & 1],
                       dim=-1)


def _node_table(octree, exsum):
    """``prev_exsum << 8 | byte`` a node: one gather gives a node's child
    mask and the hierarchy index before its first child."""
    prev_ex = torch.cat([exsum.new_zeros(1), exsum[:-1]]).to(_I32)
    return (prev_ex << 8) | (octree.to(_I32) & 0xFF)


def _root_hit(origin, inv_dir):
    lo = torch.full_like(origin, -1.0)
    return _ray_aabb(origin, inv_dir, lo, -lo)[0]


def _raytrace_fixed(octree, exsum, origin, direction, level, capacity,
                    return_exit=False):
    """Fixed-capacity traversal → (ridx, pidx, t_entry, t_exit, valid,
    level_counts, overflowed): ``level_counts`` (level,) int32, the true
    number of (ray, node) candidates after each level (exact up to and
    including the first level that overflows); ``overflowed`` a bool
    tensor, set when some level produced more than ``capacity`` and was
    truncated. Each level compacts by a cumsum rank, as JAX's
    ``jnp.nonzero(size=, fill_value=)``."""
    del return_exit
    device, dtype = origin.device, origin.dtype
    num_rays = origin.shape[0]
    inv_dir = _inv_dir(direction)
    neg_mask = _neg_mask(direction)
    octant = torch.arange(8, dtype=_I32, device=device)
    popc = popcount_table(device)
    exsum = exsum.to(_I32)

    ridx = torch.arange(num_rays, dtype=_I32, device=device)
    nidx = torch.zeros((num_rays,), dtype=_I32, device=device)
    coords = torch.zeros((num_rays, 3), dtype=_I32, device=device)
    valid = _root_hit(origin, inv_dir)
    level_counts = []
    overflowed = torch.zeros((), dtype=torch.bool, device=device)
    for lv in range(level):
        c = ridx.shape[0]
        cell = 2.0 / (2 ** (lv + 1))
        r = ridx.long()
        byte = octree[nidx.long()].to(_I32)
        child_oct = octant[None, :] ^ neg_mask[r][:, None]        # (C, 8)
        has_child = ((byte[:, None] >> child_oct) & 1) == 1
        child_coords = coords[:, None, :] * 2 + _octant_bits(child_oct)
        bmin = child_coords.to(dtype) * cell - 1.0
        hit, _, _ = _ray_aabb(origin[r][:, None, :], inv_dir[r][:, None, :],
                              bmin, bmin + cell)
        cand = (valid[:, None] & has_child & hit).reshape(-1)
        below = byte[:, None] & ((1 << child_oct) - 1)
        base = torch.where(nidx > 0, exsum[torch.clamp(nidx - 1, min=0).long()],
                           0)
        child_nidx = (base[:, None] + popc[below.long()] + 1).reshape(-1)

        rank = torch.cumsum(cand, 0, dtype=_I32)
        true_count = rank[-1]
        new_cap = min(capacity, c * 8)
        overflowed = overflowed | (true_count > new_cap)
        level_counts.append(true_count)
        # the k-th candidate goes to slot k; the rest to the dump slot
        dest = torch.where(cand & (rank <= new_cap), rank - 1, new_cap)
        sel = torch.full((new_cap + 1,), c * 8, dtype=torch.int64,
                         device=device)
        sel.scatter_(0, dest.long(), torch.arange(c * 8, device=device))
        sel = sel[:new_cap]
        in_range = sel < c * 8
        sel_safe = torch.where(in_range, sel, 0)
        ridx = torch.where(in_range, ridx[sel_safe // 8], 0)
        nidx = torch.where(in_range, child_nidx[sel_safe], 0)
        coords = torch.where(in_range[:, None],
                             child_coords.reshape(-1, 3)[sel_safe], 0)
        valid = in_range

    cell = 2.0 / (2 ** level)
    bmin = coords.to(dtype) * cell - 1.0
    r = ridx.long()
    _, t_in, t_out = _ray_aabb(origin[r], inv_dir[r], bmin, bmin + cell)
    counts = (torch.stack(level_counts) if level_counts
              else torch.zeros((0,), dtype=_I32, device=device))
    return ridx, nidx, t_in, t_out, valid, counts, overflowed


def _packed_child_off(child):
    """An octant's offset in the packed coords ``x | y << 10 | z << 20``."""
    return (((child >> 2) & 1) | (((child >> 1) & 1) << 10)
            | ((child & 1) << 20))


def _packed_slab(pc, cellw, dtype, ro, ri):
    """The slab test of the cells at packed coords ``pc`` (width
    ``cellw``) against rays of origin ``ro`` and inverse direction ``ri``,
    each a tuple of (C,) channels → (t_min, t_max)."""
    ts = []
    for axis, (o, i) in enumerate(zip(ro, ri)):
        b = ((pc >> (10 * axis)) & 1023).to(dtype) * cellw - 1.0
        ts.append(((b - o) * i, (b + cellw - o) * i))
    tmin = torch.maximum(torch.maximum(torch.minimum(*ts[0]),
                                       torch.minimum(*ts[1])),
                         torch.minimum(*ts[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(*ts[0]),
                                       torch.maximum(*ts[1])),
                         torch.maximum(*ts[2]))
    return tmin, tmax


def _raytrace_frontier(octree, exsum, origin, direction, level, capacity):
    """Global compacted-frontier breadth-first traversal: every state
    channel a flat (C,) tensor of ``capacity`` slots; cell coords packed
    ``x | y << 10 | z << 20`` (level <= 10), the ray id and its octant mask
    as ``ridx << 3 | neg``, a node's record as ``prev_exsum << 8 | byte``.
    Each level tests the 8 visit positions of every slot as one (8, C)
    batch, counts each slot's children, takes an exclusive sum, and scatters
    one token (slot·8 + visit position) to each child's place in a buffer of
    c + 1, every inactive or overflowing lane to the dump slot c.

    Returns (ridx, nidx, t_in, t_out, valid, level_counts, overflowed),
    nuggets ray-major and front to back per ray; ``valid`` is a prefix.
    """
    device, dtype = origin.device, origin.dtype
    num_rays = origin.shape[0]
    c = int(capacity)
    if level > 10:
        raise NotImplementedError("packed coords support level <= 10")
    if 8 * octree.shape[0] >= _NODE_TABLE_LIMIT or c >= (1 << 26):
        raise NotImplementedError("octree/capacity too large for packed "
                                  "int32 records")
    if c < num_rays:
        raise ValueError(f"capacity {c} < num_rays {num_rays}")
    inv_dir = _inv_dir(direction)
    ro = origin.unbind(-1)
    ri = inv_dir.unbind(-1)
    node_tab = _node_table(octree, exsum)
    popc = popcount_table(device)

    iota_c = torch.arange(c, dtype=_I32, device=device)
    pad = c - num_rays
    pc = torch.zeros((c,), dtype=_I32, device=device)
    nidx = torch.zeros((c,), dtype=_I32, device=device)
    rstate = torch.nn.functional.pad(
        (torch.arange(num_rays, dtype=_I32, device=device) << 3)
        | _neg_mask(direction), (0, pad))
    mask = torch.nn.functional.pad(_root_hit(origin, inv_dir), (0, pad))
    visit = torch.arange(8, dtype=_I32, device=device)[:, None]
    # token of visit position v in slot s, +1 so that 0 is empty
    tokens = ((iota_c[None, :] << 3) | visit) + 1
    level_counts = []
    overflowed = torch.zeros((), dtype=torch.bool, device=device)
    for lv in range(level):
        cellw = 2.0 / (2 ** (lv + 1))
        nt = node_tab[nidx.long()]
        byte = nt & 0xFF
        neg = rstate & 7
        r = (rstate >> 3).long()
        rro = tuple(ch[r] for ch in ro)
        rri = tuple(ch[r] for ch in ri)
        child = neg[None, :] ^ visit                            # (8, C)
        has = ((byte[None, :] >> child) & 1) == 1
        tmin, tmax = _packed_slab((pc << 1)[None, :] + _packed_child_off(
            child), cellw, dtype, rro, rri)
        cand = mask[None, :] & has & (tmax >= torch.clamp(tmin, min=0.0))
        cnt = cand.sum(0, dtype=_I32)
        off = torch.cumsum(cnt, 0, dtype=_I32) - cnt            # exclusive
        total = off[-1] + cnt[-1]
        level_counts.append(total)
        overflowed = overflowed | (total > c)
        # visit v of a slot lands after the slot's earlier visits
        dest = off[None, :] + torch.cumsum(cand, 0, dtype=_I32) - 1
        dest = torch.where(cand & (dest < c), dest, c)
        token_buf = torch.zeros((c + 1,), dtype=_I32, device=device)
        token_buf.scatter_(0, dest.reshape(-1).long(), tokens.reshape(-1))

        new_mask = iota_c < torch.clamp(total, max=c)
        tok = torch.where(new_mask, token_buf[:c] - 1, 0)
        p = (tok >> 3).long()
        pc_p = pc[p]
        nt_p = nt[p]
        rstate = rstate[p]
        child = (tok & 7) ^ (rstate & 7)
        pc = (pc_p << 1) + _packed_child_off(child)
        below = (nt_p & 0xFF) & ((1 << child) - 1)
        nidx = (nt_p >> 8) + popc[below.long()] + 1
        mask = new_mask

    r = (rstate >> 3).long()
    t_in, t_out = _packed_slab(pc, 2.0 / (2 ** level), dtype,
                               tuple(ch[r] for ch in ro),
                               tuple(ch[r] for ch in ri))
    counts = (torch.stack(level_counts) if level_counts
              else torch.zeros((0,), dtype=_I32, device=device))
    return rstate >> 3, nidx, t_in, t_out, mask, counts, overflowed


def _decode_morton(m, nbits):
    """(...,) int64 Morton codes → (..., 3) int64 cell coords."""
    out = []
    for axis in (2, 1, 0):       # x, y, z at bit offsets 2, 1, 0
        v = torch.zeros_like(m)
        for b in range(nbits):
            v = v | (((m >> (3 * b + axis)) & 1) << b)
        out.append(v)
    return torch.stack(out, dim=-1)


def _raytrace_perray(octree, exsum, origin, direction, level, slots,
                     compaction="sort"):
    """Per-ray fixed-slot breadth-first traversal: each ray owns ``slots``
    (K) node slots; each level expands (R, K) nodes to (R, K·8) children
    and compacts within each row, by a stable sort of the candidates'
    positions (``"sort"``) or by a cumsum rank and K masked sums
    (``"rank"``), both in the same front-to-back order.

    Returns (nidx (R, K) int32, morton (R, K), t_in (R, K), t_out (R, K),
    valid (R, K) bool, overflowed bool tensor), ``overflowed`` set when some
    ray needed more than K slots at some level. Above level 10 the cell
    coords travel as Morton codes in int64 (``morton`` is then int64, else
    int32): JAX's int32 codes wrap there and lose the coarsest x and y bits
    (fault F20, not copied).
    """
    device, dtype = origin.device, origin.dtype
    num_rays = origin.shape[0]
    k = slots
    inv_dir = _inv_dir(direction)
    neg_mask = _neg_mask(direction)
    octant = torch.arange(8, dtype=_I32, device=device)
    popc = popcount_table(device)
    combine_nodes = 8 * octree.shape[0] < _NODE_TABLE_LIMIT
    node_tab = _node_table(octree, exsum) if combine_nodes else None
    exsum = exsum.to(_I32)
    packed_ok = level <= 10

    def unpack(pc):
        return torch.stack([pc & 1023, (pc >> 10) & 1023, pc >> 20], dim=-1)

    nidx = torch.zeros((num_rays, k), dtype=_I32, device=device)
    # above level 10 the Morton codes outgrow int32 (JAX's wrap there: F20)
    pc = torch.zeros((num_rays, k), dtype=_I32 if packed_ok else torch.int64,
                     device=device)
    valid = torch.zeros((num_rays, k), dtype=torch.bool, device=device)
    valid[:, 0] = _root_hit(origin, inv_dir)
    overflowed = torch.zeros((), dtype=torch.bool, device=device)
    big = 8 * k
    o3 = origin[:, None, None, :]
    i3 = inv_dir[:, None, None, :]
    for lv in range(level):
        cell = 2.0 / (2 ** (lv + 1))
        safe_n = torch.where(valid, nidx, 0).long()
        if combine_nodes:
            rec = node_tab[safe_n]
            byte, base = rec & 0xFF, rec >> 8
        else:
            byte = octree[safe_n].to(_I32)
            # dead slots hold stale indices: read node 0 there (F27)
            base = torch.where(safe_n > 0,
                               exsum[torch.clamp(safe_n - 1, min=0)], 0)
        child_oct = octant[None, None, :] ^ neg_mask[:, None, None]
        has_child = ((byte[..., None] >> child_oct) & 1) == 1
        if packed_ok:
            child_pc = (pc[..., None] << 1) + _packed_child_off(child_oct)
            coords = unpack(child_pc)
        else:
            child_pc = (pc[..., None] << 3) | child_oct
            coords = _decode_morton(child_pc, lv + 1)
        bmin = coords.to(dtype) * cell - 1.0
        hit, _, _ = _ray_aabb(o3, i3, bmin, bmin + cell)
        cand = valid[..., None] & has_child & hit              # (R, K, 8)
        below = byte[..., None] & ((1 << child_oct) - 1)
        child_n = base[..., None] + popc[below.long()] + 1

        flat_cand = cand.reshape(num_rays, k * 8)
        count = flat_cand.sum(-1, dtype=_I32)
        overflowed = overflowed | torch.any(count > k)
        flat_pc = child_pc.reshape(num_rays, k * 8)
        flat_n = child_n.reshape(num_rays, k * 8)
        if compaction == "rank":
            rank = torch.cumsum(flat_cand, -1, dtype=_I32)
            pc_cols, n_cols = [], []
            for j in range(k):
                sel = flat_cand & (rank == j + 1)
                pc_cols.append(torch.where(sel, flat_pc, 0).sum(
                    -1, dtype=pc.dtype))
                n_cols.append(torch.where(sel, flat_n, 0).sum(-1, dtype=_I32))
            nidx = torch.stack(n_cols, dim=-1)
            pc = torch.stack(pc_cols, dim=-1)
            valid = (torch.arange(k, dtype=_I32, device=device)[None, :]
                     < torch.clamp(count, max=k)[:, None])
        else:
            key = torch.where(flat_cand,
                              torch.arange(k * 8, dtype=_I32, device=device),
                              big)
            key_s, order = torch.sort(key, dim=-1, stable=True)
            order = order[:, :k]
            nidx = torch.gather(flat_n, 1, order)
            pc = torch.gather(flat_pc, 1, order)
            valid = key_s[:, :k] < big

    cell = 2.0 / (2 ** level)
    if packed_ok:
        coords = unpack(pc)
        morton = torch.zeros_like(pc)
        for b in range(level):
            morton = morton | ((((pc >> b) & 1) << (3 * b + 2))
                               | (((pc >> (10 + b)) & 1) << (3 * b + 1))
                               | (((pc >> (20 + b)) & 1) << (3 * b)))
    else:
        coords = _decode_morton(pc, level)
        morton = pc
    bmin = coords.to(dtype) * cell - 1.0
    _, t_in, t_out = _ray_aabb(origin[:, None, :], inv_dir[:, None, :],
                               bmin, bmin + cell)
    return nidx, morton, t_in, t_out, valid, overflowed


def _capacity_ceiling(num_rays, num_leaf, level):
    """Worst-case nugget count: every ray visits every leaf."""
    return int(max(num_rays, 1) * max(num_leaf, 1))


def _read(*tensors):
    """Several device scalars as Python numbers, in one read."""
    return torch.stack([t.to(torch.int64) for t in tensors]).tolist()


def unbatched_raytrace(octree, point_hierarchy, pyramid, exsum, origin,
                       direction, level, return_depth=True, with_exit=False,
                       max_nuggets=None):
    """Trace rays against an SPC → depth-sorted (ray, point) nuggets
    (ridx, pidx[, depth]) on the rays' device: ``depth`` (N, 1) t_in, or
    (N, 2) t_in and t_out ``with_exit``.

    With ``max_nuggets=None`` the frontier path runs from a capacity of
    ``4 * num_rays`` and doubles it while the traversal overflows, so no
    nugget is dropped (the per-ray path, doubling its slots, where the
    frontier's packed int32 fields cannot hold level or octree). An explicit
    ``max_nuggets`` is trusted: if it overflows, a warning is emitted and
    the truncated, still depth-sorted nuggets come back
    (:func:`raytrace_overflow_report` sizes it). The host reads the
    overflow flag and the count once a call.
    """
    num_rays = origin.shape[0]
    num_leaf = int(host(pyramid)[0, level])
    octree = octree.to(origin.device)
    exsum = exsum.to(origin.device)

    if max_nuggets is None:
        use_frontier = (level <= 10
                        and 8 * octree.shape[0] < _NODE_TABLE_LIMIT
                        and num_rays < (1 << 26))
        if use_frontier:
            ceiling = min(_capacity_ceiling(num_rays, num_leaf, level),
                          (1 << 26) - 1)
            cap = min(max(4 * num_rays, 1024), ceiling)
            while True:
                ridx, pidx, t_in, t_out, mask, _, overflowed = \
                    _raytrace_frontier(octree, exsum, origin, direction,
                                       level, cap)
                over, count = _read(overflowed, mask.sum())
                if not over or cap >= ceiling:
                    break
                cap = min(cap * 2, ceiling)
            # valid entries form a prefix (mask = iota < count)
            ridx, pidx = ridx[:count], pidx[:count]
            t_in, t_out = t_in[:count], t_out[:count]
        else:
            k = 16
            k_ceiling = max(num_leaf, 16)
            while True:
                nidx, _, t_in2, t_out2, valid2, overflowed = _raytrace_perray(
                    octree, exsum, origin, direction, level, k)
                if not bool(overflowed) or k >= k_ceiling:
                    break
                k = min(k * 2, k_ceiling)
            sel = torch.nonzero(valid2.reshape(-1)).squeeze(-1)
            ridx = (sel // k).to(_I32)
            pidx = nidx.reshape(-1)[sel]
            t_in = t_in2.reshape(-1)[sel]
            t_out = t_out2.reshape(-1)[sel]
    else:
        ceiling = _capacity_ceiling(num_rays, num_leaf, level)
        max_nuggets = min(int(max_nuggets), ceiling)
        ridx, pidx, t_in, t_out, valid, _, overflowed = _raytrace_fixed(
            octree, exsum, origin, direction, level, max_nuggets,
            return_exit=with_exit)
        over, count = _read(overflowed, valid.sum())
        if over:
            warnings.warn(
                f"unbatched_raytrace: max_nuggets={max_nuggets} overflowed — "
                f"nuggets were dropped. Use raytrace_overflow_report to size "
                f"the buffer, or pass max_nuggets=None to auto-grow.")
        ridx, pidx = ridx[:count], pidx[:count]
        t_in, t_out = t_in[:count], t_out[:count]

    if return_depth:
        depth = (torch.stack([t_in, t_out], dim=-1) if with_exit
                 else t_in[:, None])
        return ridx, pidx, depth
    return ridx, pidx


def raytrace_overflow_report(octree, point_hierarchy, pyramid, exsum, origin,
                             direction, level, max_nuggets):
    """Check a raytrace buffer capacity → dict with ``level_counts`` (true
    surviving candidates per level, numpy; exact up to and including the
    first overflowing level, lower bounds beyond it), ``max_level_count``,
    ``capacity`` and ``overflowed`` (True: :func:`unbatched_raytrace` with
    this ``max_nuggets`` would drop nuggets)."""
    *_, level_counts, overflowed = _raytrace_fixed(
        octree.to(origin.device), exsum.to(origin.device), origin, direction,
        level, int(max_nuggets))
    counts = level_counts.cpu().numpy()
    return {
        "level_counts": counts,
        "max_level_count": int(counts.max()) if counts.size else 0,
        "capacity": int(max_nuggets),
        "overflowed": bool(overflowed),
    }


# ---------------------------------------------------------------------------
# packed ray ops
# ---------------------------------------------------------------------------

def mark_pack_boundaries(pack_ids):
    """True where a new pack starts in a sorted id tensor."""
    first = torch.ones((1,), dtype=torch.bool, device=pack_ids.device)
    return torch.cat([first, pack_ids[1:] != pack_ids[:-1]])


def _segment_ids(boundaries):
    return torch.cumsum(boundaries, 0) - 1


def diff(feats, boundaries):
    """out[i] = feats[i + 1] − feats[i], 0 at the end of each pack."""
    nxt = torch.cat([feats[1:], torch.zeros_like(feats[:1])], dim=0)
    is_last = torch.cat([boundaries[1:], boundaries.new_ones((1,))])
    return torch.where(is_last[:, None], 0.0, nxt - feats)


def sum_reduce(feats, boundaries):
    """Per-pack sum → (num_packs, D), differentiable. Reads the pack count
    on the host."""
    seg = _segment_ids(boundaries)
    out = feats.new_zeros((int(boundaries.sum()),) + feats.shape[1:])
    return out.index_add(0, seg, feats)


def prod_reduce(feats, boundaries):
    """Per-pack product → (num_packs, D), differentiable (zeros too). Reads
    the pack count on the host."""
    seg = _segment_ids(boundaries)
    out = feats.new_ones((int(boundaries.sum()),) + feats.shape[1:])
    index = seg.reshape((-1,) + (1,) * (feats.dim() - 1)).expand_as(feats)
    return out.scatter_reduce(0, index, feats, "prod")


def _segmented_scan(feats, boundaries, op, identity, exclusive, reverse):
    """Flagged Hillis–Steele scan along axis 0: log2 N passes, each
    combining an element with the one ``shift`` before it unless a pack
    starts between them."""
    if reverse:
        feats = feats.flip(0)
        # in reversed order, packs start where the original ones ended
        boundaries = torch.cat([boundaries.new_ones((1,)),
                                boundaries.flip(0)[:-1]])
    vals, flags = feats, boundaries
    n = feats.shape[0]
    shift = 1
    while shift < n:
        combined = op(vals[:-shift], vals[shift:])
        stop = flags[shift:].reshape((-1,) + (1,) * (feats.dim() - 1))
        vals = torch.cat([vals[:shift],
                          torch.where(stop, vals[shift:], combined)])
        flags = torch.cat([flags[:shift], flags[shift:] | flags[:-shift]])
        shift *= 2
    if exclusive:
        shifted = torch.cat([torch.full_like(vals[:1], identity), vals[:-1]])
        vals = torch.where(boundaries[:, None], identity, shifted)
    if reverse:
        vals = vals.flip(0)
    return vals


def cumsum(feats, boundaries, exclusive=False, reverse=False):
    """Per-pack cumulative sum."""
    return _segmented_scan(feats, boundaries, torch.add, 0.0, exclusive,
                           reverse)


def cumprod(feats, boundaries, exclusive=False, reverse=False):
    """Per-pack cumulative product."""
    return _segmented_scan(feats, boundaries, torch.mul, 1.0, exclusive,
                           reverse)


def exponential_integration(feats, tau, boundaries, exclusive=True):
    """Beer–Lambert transmittance integration in cumsum form → (integrated
    (num_packs, D), transmittance (N, 1))."""
    alpha = 1.0 - torch.exp(-tau)
    transmittance = torch.exp(-1.0 * cumsum(tau, boundaries,
                                            exclusive=exclusive))
    transmittance = transmittance * alpha
    return sum_reduce(transmittance * feats, boundaries), transmittance


def mark_first_hit(ridx):
    """Deprecated alias of :func:`mark_pack_boundaries`."""
    warnings.warn("mark_first_hit is deprecated, use mark_pack_boundaries",
                  DeprecationWarning)
    return mark_pack_boundaries(ridx)
