"""Particle-particle penalty contact with friction, in PyTorch.

Counterpart of ``kaolin_tpu/physics/common/collisions.py``: the same three
broad phases over one narrow phase, the same fixed-capacity contact buffer
and the same Kronecker-factored (q-form) contact terms. The JAX module holds
no Pallas kernel; this one is plain PyTorch.

* ``dense`` — the (N, N) pairwise-distance mask; exact, O(N²).
* ``grid`` — the occupied-cell grid: points sorted by cell id, ranked in
  their cell by a scan, scattered into a (K, M) slot table over the M
  occupied cells; each occupied cell reads its 13 half-stencil neighbour
  blocks through a dense cell → occupied-rank map, and the narrow test runs
  on (K, M, K, 14) candidate blocks. Pairs compact per point (``topk`` over
  each point's 14-cell row, capacity ``point_contact_capacity``), then by one
  stable sort of N·pp slots down to ``max_contacts``.
* ``sweep`` — sort along the longest axis and test a window of the next
  ``sweep_window`` points.

Detection reads nothing back to the host: every shape is fixed by the
capacities, a list is compacted by a ``cumsum`` that gives each true element
its slot (the JAX module's ``nonzero(size=…)``), and a scatter that JAX
drops out of range writes into a buffer long enough for those indices and
is sliced. So a detection, and the sim step around it, can be captured in a
CUDA graph. Capacity overflow is reported in a diagnostics dict and an int32
bitmask (:meth:`Collision.diag_flags`), never silent.

The contact jacobian is never formed: contact i's LBS row is
``w_i ⊗ [x_i; 1] ⊗ I₃``, so offsets, the gradient pullback, the reduced
Hessian and the step bounds are dense products with the per-side factors
(:meth:`Collision.pullback_gradient`, :meth:`Collision.reduced_hessian`,
:meth:`Collision.get_bounds_q`).

Energy: the quadratic-log barrier ``E = −(d̂−1)² log(d̂−rp)`` on the normal
gap, active for ``rp < d̂ ≤ 1``, plus regularized stick-slip Coulomb
friction on the tangential slip velocity.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from kaolin_tpu_torch.utils.numerics import nonzero_static

__all__ = ["Collision", "Contacts"]

NULL = -1

# lexicographically positive half stencil: each unordered pair of adjacent
# cells appears once
_HALF_OFFSETS = [(0, 0, 1), (0, 1, -1), (0, 1, 0), (0, 1, 1),
                 (1, -1, -1), (1, -1, 0), (1, -1, 1),
                 (1, 0, -1), (1, 0, 0), (1, 0, 1),
                 (1, 1, -1), (1, 1, 0), (1, 1, 1)]

_INT_MAX = 2 ** 31 - 1


class Contacts(NamedTuple):
    """Fixed-capacity contact buffer (shapes (C,) or (C, 3)).

    ``wa``/``wb`` (C, H) and ``xa``/``xb`` (C, 4) are the per-side LBS
    factors (q-form), None when detection ran without skinning weights;
    then ``dx0`` (N, 3) is kept for the gather form. ``qat``/``qbt``
    (4H, C) are the factors ``w ⊗ [x;1]``, made once at detection."""
    indices_a: torch.Tensor       # int64, NULL for static or invalid
    indices_b: torch.Tensor
    normals: torch.Tensor         # (C, 3)
    kinematic_gaps: torch.Tensor  # (C, 3)
    valid: torch.Tensor           # bool (C,)
    dx0: Optional[torch.Tensor] = None
    wa: Optional[torch.Tensor] = None
    wb: Optional[torch.Tensor] = None
    xa: Optional[torch.Tensor] = None
    xb: Optional[torch.Tensor] = None
    qat: Optional[torch.Tensor] = None
    qbt: Optional[torch.Tensor] = None


def _q_factor_t(w, x):
    """The transposed q factor, (4H, C)."""
    c = w.shape[0]
    return (w.T[:, None, :] * x.T[None, :, :]).reshape(-1, c)


def _z_mat(zq):
    """Raw-basis DOF vector (12H,) → (4H, 3) matrix Z with
    delta (C, 3) = q (C, 4H) @ Z; DOF z[(h, r, s)] is column 12h + 4r + s."""
    h = zq.shape[-1] // 12
    return zq.reshape(h, 3, 4).transpose(1, 2).reshape(4 * h, 3)


def _set_drop(out, idx, values, dim=0):
    """``out.at[idx].set(values, unique_indices=True, mode="drop")`` along
    ``dim`` for distinct ``idx`` whose out-of-range entries lie in
    [len, len + len(idx)): they write into a tail that is sliced off."""
    n = out.shape[dim]
    tail = list(out.shape)
    tail[dim] = idx.shape[0]
    buf = torch.cat([out, out.new_zeros(tail)], dim)
    # out of place, so that ``torch.func.vmap`` batches it
    return buf.index_copy(dim, idx, values).narrow(dim, 0, n)


class Collision:
    """Scene-wide particle contact, with the arguments and defaults of the
    JAX package's ``Collision``. Capacities and grid geometry are plain
    attributes; :meth:`configure_grid` sets them from points on the host."""

    def __init__(self, dt, collision_particle_radius=0.1, detection_ratio=1.5,
                 impenetrable_barrier_ratio=0.5,
                 ignore_self_collision_ratio=100000.0,
                 collision_penalty_stiffness=100.0,
                 friction_regularization=0.1, friction_fluid=0.1, friction=0.5,
                 max_contacting_pairs=10000, bounds=True,
                 broad_phase="dense", cell_capacity=16, sweep_window=128,
                 slot_contact_capacity=None, max_occupied_cells=2048,
                 point_contact_capacity=32):
        self.dt = float(dt)
        self.collision_radius = float(collision_particle_radius)
        self.collision_detection_ratio = float(detection_ratio)
        self.collision_barrier_ratio = float(impenetrable_barrier_ratio)
        self.ignore_self_collision_ratio = float(ignore_self_collision_ratio)
        self.collision_penalty_stiffness = float(collision_penalty_stiffness)
        self.friction_reg = float(friction_regularization)
        self.friction_fluid = float(friction_fluid)
        self.friction = float(friction)
        self.max_contacts = int(max_contacting_pairs)
        self.bounds = bounds
        if broad_phase not in ("dense", "grid", "sweep"):
            raise ValueError(f"unknown broad_phase {broad_phase!r}")
        self.broad_phase = broad_phase
        self.cell_capacity = int(cell_capacity)
        self.sweep_window = int(sweep_window)
        # accepted and unused, as in the JAX package (no per-particle stage)
        self.slot_contact_capacity = (None if slot_contact_capacity is None
                                      else int(slot_contact_capacity))
        self.max_occupied_cells = int(max_occupied_cells)
        self.point_contact_capacity = int(point_contact_capacity)
        self.grid_dims = None           # (Gx, Gy, Gz)
        self.grid_origin = None         # (3,) float32 numpy
        self.grid_cell = None           # float cell side
        self._grid_tensors = {}         # device → (origin, cell) tensors

    @property
    def detection_radius(self):
        return 2.0 * self.collision_radius * self.collision_detection_ratio

    # bits of the overflow bitmask (see diag_flags)
    FLAG_CELL_OVERFLOW = 1       # a cell held more than cell_capacity points
    FLAG_OCC_OVERFLOW = 2        # occupied cells exceeded max_occupied_cells
    FLAG_CONTACTS_OVERFLOW = 4   # true pairs exceeded max_contacting_pairs
    FLAG_WINDOW_OVERFLOW = 8     # sweep window exceeded
    FLAG_PP_OVERFLOW = 16        # a point's fan-out exceeded
    #                              point_contact_capacity (grid top-k)
    FLAG_SLOT_OVERFLOW = 2       # legacy alias

    @staticmethod
    def diag_flags(diag):
        """A :meth:`detection_diagnostics` dict → one int32 bitmask (0-dim
        tensor), to OR across steps on the device and read once."""
        return sum(diag[key].to(torch.int32) * bit for key, bit in (
            ("cell_overflow", Collision.FLAG_CELL_OVERFLOW),
            ("occ_overflow", Collision.FLAG_OCC_OVERFLOW),
            ("contacts_overflow", Collision.FLAG_CONTACTS_OVERFLOW),
            ("window_overflow", Collision.FLAG_WINDOW_OVERFLOW),
            ("pp_overflow", Collision.FLAG_PP_OVERFLOW)) if key in diag)

    def configure_grid(self, rest_pts, obj_ids=None, margin=0.5,
                       mem_budget=1.5e9, auto_capacities=True,
                       headroom=1.5, headroom_k=None, bounds_pts=None):
        """Fix the grid's geometry from points (host numpy, once): the cell
        side by a cost search from the detection radius upward, scored by
        the narrow-phase test count M·14·K² under ``mem_budget`` bytes of
        candidate blocks; dims rounded up to a multiple of 4. With
        ``auto_capacities``, K (``cell_capacity``), M
        (``max_occupied_cells``) and the per-point fan-out
        (``point_contact_capacity``) are measured from the points with
        ``headroom`` (``headroom_k`` for K). ``bounds_pts`` widens the grid's
        span (a re-measure mid-simulation passes the rest points). The
        JAX package's ``configure_grid``, line for line, so both give the
        same geometry and capacities on the same points."""
        pts = np.asarray(rest_pts, np.float32)
        n = max(len(pts), 1)
        radius = self.detection_radius
        span = (pts if bounds_pts is None
                else np.concatenate([pts, np.asarray(bounds_pts,
                                                     np.float32)]))
        lo0 = span.min(0)
        hi0 = span.max(0)
        ext = np.maximum(hi0 - lo0, 1e-6)
        slack = np.maximum(margin * ext, 2.0 * radius)
        lo = lo0 - slack
        hi = hi0 + slack

        def mult(x, step, lo_, hi_):
            # a small multiple, not a power of two: the cost is M·14·K²
            return int(min(hi_, max(lo_, step * int(np.ceil(
                max(x, 1) / step)))))

        # K enters the cost squared, M linearly: K gets the tighter headroom
        hk = headroom if headroom_k is None else headroom_k

        def measure(cell):
            dims = np.ceil((hi - lo) / cell).astype(np.int64)
            dims = (np.ceil(dims / 4.0) * 4).astype(np.int64)
            cc = np.clip(np.floor((pts - lo) / cell).astype(np.int64),
                         0, dims - 1)
            lin = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
            counts = (np.unique(lin, return_counts=True)[1]
                      if lin.size else np.array([1]))
            k = mult(hk * counts.max(), 8, 8, 512)
            m = mult(headroom * counts.size, 128, 128, 2 * n)
            num_cells = int(dims.prod())
            tests = m * k * 14 * k
            # the float32 candidate blocks, the neighbour gather, the map
            peak_bytes = (4 * tests + 4 * 8 * k * 14 * m
                          + 4 * num_cells)
            return dims, k, m, tests, peak_bytes

        best = None
        for i in range(40):
            cell = radius * (1.26 ** i)
            dims, k, m, tests, peak_bytes = measure(cell)
            fits = peak_bytes <= mem_budget
            score = (not fits, tests if fits else peak_bytes)
            if best is None or score < best[0]:
                best = (score, cell, dims, k, m)
            if int(dims.prod()) <= 64:
                break
        _, cell, dims, k, m = best
        self.grid_dims = tuple(int(d) for d in dims)
        self.grid_origin = np.asarray(lo, np.float32)
        self.grid_cell = float(cell)
        self._grid_tensors = {}
        if auto_capacities:
            self.cell_capacity = k
            self.max_occupied_cells = m
            # per-point fan-out with detection's narrow mask, chunked
            d2max = radius * radius
            immune_lin = (self.collision_radius
                          * self.ignore_self_collision_ratio)
            oid = (None if obj_ids is None
                   else np.asarray(obj_ids).reshape(-1))
            fan_max = 0
            for i0 in range(0, len(pts), 512):
                blk = pts[i0:i0 + 512]
                d2 = ((blk[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
                near = d2 <= d2max
                if oid is not None:
                    near &= ~((oid[i0:i0 + 512, None] == oid[None, :])
                              & (d2 < immune_lin))
                    fan = near.sum(1)
                else:
                    fan = near.sum(1) - 1     # drop the self pair
                if len(fan):
                    fan_max = max(fan_max, int(fan.max()))
            self.point_contact_capacity = mult(
                headroom * max(fan_max, 4), 8, 8, 14 * k)
        return self

    def grid_tensors(self, device):
        """The grid's origin (3,) and cell side (1,) as float32 tensors on
        ``device``, made once a configuration: a CUDA graph capture may not
        copy from the host, and a graph that reads them keeps this object
        (and so them) alive."""
        device = torch.device(device)
        if device not in self._grid_tensors:
            self._grid_tensors[device] = (
                torch.from_numpy(self.grid_origin).to(device),
                torch.tensor([self.grid_cell], dtype=torch.float32,
                             device=device))
        return self._grid_tensors[device]

    # -- narrow phase --
    def _narrow_mask(self, d2, rest_d2, obj_a, obj_b):
        """Within the detection radius and not self-collision-immune. The
        immune test compares a SQUARED rest distance with the linear
        ``collision_radius * ignore_self_collision_ratio``, as the reference
        kernel does."""
        radius = self.detection_radius
        immune = (obj_a == obj_b) & (
            rest_d2 < self.collision_radius * self.ignore_self_collision_ratio)
        return (d2 <= radius * radius) & ~immune

    @staticmethod
    def _sqdist(a, b):
        """Σ over the last axis of (a − b)², summed x, y, z in that order."""
        d = a - b
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]

    def _pair_mask_of(self, ca, cb, cur, cp_x0, cp_obj_ids, radius,
                      cp_exclude=None):
        """The exact narrow test on candidate (ca, cb) index pairs, deduped
        (a < b)."""
        d2 = self._sqdist(cur[ca], cur[cb])
        rest_d2 = self._sqdist(cp_x0[ca], cp_x0[cb])
        m = (ca < cb) & self._narrow_mask(d2, rest_d2, cp_obj_ids[ca],
                                          cp_obj_ids[cb])
        if cp_exclude is not None:
            m = m & ~cp_exclude[ca] & ~cp_exclude[cb]
        return m

    # -- the occupied-cell grid --
    def _cellgrid_pairs(self, cur, cp_x0, cp_obj_ids, cp_is_static,
                        cp_exclude=None):
        """Compact pairs ``(ia, ib, valid)`` of shape (max_contacts,) and a
        diagnostics dict. ``cp_exclude`` (N,) bool removes points from
        detection (no binning, no footprint in any count)."""
        if self.grid_dims is None:
            # set up from the rest points on the host, as the JAX package
            # does outside jit; a graph capture cannot read them back
            if cur.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "grid broad phase captured before configure_grid(); "
                    "call Collision.configure_grid(rest_pts) first")
            self.configure_grid(cp_x0.detach().cpu().numpy())
        dev = cur.device
        n = cur.shape[0]
        gx, gy, gz = self.grid_dims
        k = self.cell_capacity
        m_cap = self.max_occupied_cells
        num_cells = gx * gy * gz
        f32, i32, i64 = cur.dtype, torch.int32, torch.int64
        iota = torch.arange(n, device=dev)
        origin, cell_side = self.grid_tensors(dev)

        cellf = (cur - origin) / cell_side
        cols = [cellf[:, a].to(i32).clamp(0, d - 1)
                for a, d in enumerate((gx, gy, gz))]
        oob_mask = ((cellf[:, 0] < 0) | (cellf[:, 0] >= gx)
                    | (cellf[:, 1] < 0) | (cellf[:, 1] >= gy)
                    | (cellf[:, 2] < 0) | (cellf[:, 2] >= gz))
        if cp_exclude is not None:
            oob_mask = oob_mask & ~cp_exclude
        oob = oob_mask.sum()
        lin = (cols[0] * gy + cols[1]) * gz + cols[2]
        if cp_exclude is not None:
            # excluded points sort past every real cell
            lin = torch.where(cp_exclude, num_cells, lin)
        order = torch.argsort(lin, stable=True)
        lin_s = lin[order]
        real_s = (lin_s < num_cells) if cp_exclude is not None \
            else torch.ones((n,), dtype=torch.bool, device=dev)

        # in-cell rank and occupied-cell rank by scans over the sorted ids
        seg_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                               lin_s[1:] != lin_s[:-1]])
        run_first = torch.cummax(torch.where(seg_start, iota, 0), 0).values
        rank = iota - run_first
        occ_idx = torch.cumsum(seg_start, 0) - 1
        n_occ = (seg_start & real_s).sum()
        occ_overflow = n_occ > m_cap
        in_tab = (rank < k) & real_s & (occ_idx < m_cap)
        dropped = ((rank >= k) & real_s).sum()
        max_occ = torch.where(real_s, rank, -1).max() + 1

        # channels [cur(3), x0(3), meta, id+1] of each slot; an empty slot
        # is all zero, so id channel 0 marks it. Points outside the table
        # get distinct slots past its end, which are dropped.
        if n >= (1 << 24):
            raise ValueError("point ids are kept in float32: N < 2^24")
        meta = (cp_obj_ids.to(f32) * 2.0 + cp_is_static.to(f32))[order]
        packed = torch.cat([cur[order].T, cp_x0[order].T, meta[None],
                            (order + 1).to(f32)[None]], 0)         # (8, N)
        slot = torch.where(in_tab, rank * m_cap + occ_idx, k * m_cap + iota)
        grid = _set_drop(cur.new_zeros((8, k * m_cap)), slot, packed,
                         dim=1).reshape(8, k, m_cap)

        # occupied rank → cell id, and the dense cell id → occupied rank map
        # (m_cap = empty); only run starts write
        is_head = seg_start & real_s & (occ_idx < m_cap)
        head_slot = torch.where(is_head, occ_idx, m_cap + iota)
        occ_lin = _set_drop(torch.full((m_cap,), num_cells, dtype=i64,
                                       device=dev), head_slot,
                            lin_s.to(i64))
        map_idx = torch.where(is_head, lin_s.to(i64), num_cells + 1 + iota)
        cell_map = _set_drop(torch.full((num_cells + 1,), m_cap, dtype=i64,
                                        device=dev), map_idx, occ_idx)

        # the 13 half-stencil neighbours of each occupied cell → their
        # occupied ranks (m_cap: absent, a zero block)
        czc = occ_lin % gz
        cyc = (occ_lin // gz) % gy
        cxc = occ_lin // (gy * gz)
        have = occ_lin < num_cells
        nbr_lins = []
        for (ox, oy, oz) in _HALF_OFFSETS:
            nx, ny, nz = cxc + ox, cyc + oy, czc + oz
            ok = (have & (nx >= 0) & (nx < gx) & (ny >= 0) & (ny < gy)
                  & (nz >= 0) & (nz < gz))
            nbr_lins.append(torch.where(ok, (nx * gy + ny) * gz + nz,
                                        num_cells))
        nbr_occ = cell_map[torch.stack(nbr_lins)]                 # (13, M)

        grid_p = torch.cat([grid, grid.new_zeros((8, k, 1))], 2)  # (8,K,M+1)
        nb = grid_p[:, :, nbr_occ]                                # (8,K,13,M)

        # the narrow test in per-point-row layout (Ks, M, Kp, 14): each
        # a-side slot against its cell's block (the upper triangle, so an
        # in-cell pair appears once) and the 13 neighbour blocks
        part = torch.cat([grid.permute(0, 2, 1)[:, :, :, None],
                          nb.permute(0, 3, 1, 2)], 3)             # (8,M,Kp,14)
        d2 = r2 = None
        for c in range(3):
            dc = grid[c][:, :, None, None] - part[c][None]
            d2 = dc * dc if d2 is None else d2 + dc * dc
            rc = grid[3 + c][:, :, None, None] - part[3 + c][None]
            r2 = rc * rc if r2 is None else r2 + rc * rc
        a_obj = torch.floor_divide(grid[6], 2)                   # (Ks, M)
        a_ok = grid[7] > 0.5
        ar = torch.arange(k, device=dev)
        tri = ar[:, None] < ar[None, :]
        blk0 = torch.arange(14, device=dev) == 0
        mask_all = (a_ok[:, :, None, None] & (part[7] > 0.5)[None]
                    & (tri[:, None, :, None] | ~blk0)
                    & self._narrow_mask(d2, r2, a_obj[:, :, None, None],
                                        torch.floor_divide(part[6], 2)[None]))
        del d2, r2
        num_pairs = mask_all.sum()

        # per-point rows of (partner id + 2^20 where a pair, else 0), the
        # pp_cap largest of each row, then one stable sort of the N·pp_cap
        # slots down to max_contacts
        pp_cap = min(self.point_contact_capacity, k * 14)
        pid_i = part[7].to(i32)[None]                            # order + 1
        val = torch.where(mask_all, pid_i + (1 << 20), 0)
        rows = val.reshape(k * m_cap, k * 14)
        row_of = torch.where(in_tab, rank * m_cap + occ_idx, 0)
        prow = torch.where(in_tab[:, None], rows[row_of], 0)      # (N, 14K)
        vals = torch.topk(prow, pp_cap, dim=1, sorted=True).values
        pvalid = vals >= (1 << 20)
        row_cnt = (prow >= (1 << 20)).sum(1)
        pp_dropped = torch.clamp(row_cnt - pp_cap, min=0).sum()

        nslots = n * pp_cap
        sort_key = torch.where(pvalid.reshape(-1),
                               torch.arange(nslots, dtype=i32, device=dev),
                               _INT_MAX)
        ia_full = (order + 1).to(i32)[:, None].expand(n, pp_cap).reshape(-1)
        ib_full = torch.where(pvalid, vals - (1 << 20), 0).reshape(-1)
        mc = self.max_contacts      # fewer slots than mc: a shorter list
        key_s, perm = torch.sort(sort_key, stable=True)
        valid = key_s[:mc] != _INT_MAX
        if n < (1 << 15):
            # both ids in 15 bits each: one payload
            pk_s = ((ia_full << 15) | ib_full)[perm[:mc]]
            ia = torch.where(valid, (pk_s >> 15) - 1, 0)
            ib = torch.where(valid, (pk_s & 0x7FFF) - 1, 0)
        else:
            ia = torch.where(valid, ia_full[perm[:mc]] - 1, 0)
            ib = torch.where(valid, ib_full[perm[:mc]] - 1, 0)
        diag = {"num_pairs": num_pairs,
                "contacts_overflow": num_pairs > self.max_contacts,
                "pp_overflow": pp_dropped > 0,
                "cell_overflow": dropped > 0,
                "dropped_points": dropped,
                "occ_overflow": occ_overflow,
                "num_occupied": n_occ,
                "max_cell_occupancy": max_occ,
                "pp_dropped_pairs": pp_dropped,
                "out_of_bounds": oob}
        return ia.to(i64), ib.to(i64), valid, diag

    # -- sweep and prune --
    def _sweep_candidates(self, cur, cp_x0, cp_obj_ids, radius):
        """Points sorted along the longest axis; the candidates of sorted
        point i are i+1 .. i+sweep_window → (ca, cb, mask (N, W),
        window_load (N,)), ca/cb original indices."""
        n = cur.shape[0]
        w = self.sweep_window
        dev = cur.device
        ext = cur.amax(0) - cur.amin(0)
        axis = torch.argmax(ext)
        key = torch.gather(cur, 1, axis.reshape(1, 1).expand(n, 1))[:, 0]
        order = torch.argsort(key, stable=True)
        key_s = key[order]
        cur_s = cur[order]
        x0_s = cp_x0[order]
        ids_s = cp_obj_ids[order]

        def pad(a, fill):
            return torch.cat([a, torch.full((w,) + tuple(a.shape[1:]), fill,
                                            dtype=a.dtype, device=dev)])

        keyp = pad(key_s, float("inf"))
        curp = pad(cur_s, float("inf"))
        x0p = pad(x0_s, float("inf"))
        idsp = pad(ids_s, -2)
        orderp = pad(order, -1)
        idx_b = (torch.arange(n, device=dev)[:, None]
                 + torch.arange(1, w + 1, device=dev)[None, :])

        pos_b = curp[idx_b]                                       # (N, W, 3)
        key_b = keyp[idx_b]
        x0_b = x0p[idx_b]
        ids_b = idsp[idx_b]
        near_key = key_b - key_s[:, None] <= radius
        in_range = (idx_b < n) & near_key

        d2 = self._sqdist(cur_s[:, None], pos_b)
        rest_d2 = self._sqdist(x0_s[:, None], x0_b)
        immune = (ids_s[:, None] == ids_b) & (
            rest_d2 < self.collision_radius * self.ignore_self_collision_ratio)
        mask = in_range & (d2 <= radius * radius) & ~immune

        window_load = (near_key & (idx_b < n)).sum(-1)
        beyond = torch.searchsorted(key_s, key_s + radius, right=True) \
            - torch.arange(n, device=dev) - 1
        window_load = torch.maximum(window_load, beyond)
        ca = order[:, None].expand(n, w)
        cb = orderp[idx_b]
        return ca, cb, mask, window_load

    def _flat_pairs(self, cur, cp_x0, cp_obj_ids, cp_is_static,
                    cp_exclude=None):
        """Dispatch on ``broad_phase`` → (ia, ib, valid, diag), pair arrays of
        shape (max_contacts,)."""
        n = cur.shape[0]
        dev = cur.device
        radius = self.detection_radius
        if self.broad_phase == "grid":
            return self._cellgrid_pairs(cur, cp_x0, cp_obj_ids, cp_is_static,
                                        cp_exclude=cp_exclude)
        if self.broad_phase == "sweep":
            ca, cb, mask, load = self._sweep_candidates(cur, cp_x0,
                                                        cp_obj_ids, radius)
            if cp_exclude is not None:
                mask = mask & ~cp_exclude[ca] & ~cp_exclude[cb]
            num_pairs = mask.sum()
            diag = {"num_pairs": num_pairs,
                    "contacts_overflow": num_pairs > self.max_contacts,
                    "max_window_load": load.max(),
                    "window_overflow": load.max() > self.sweep_window}
            w = mask.shape[1]
            if w > 64:
                # at most 64 contacts a particle into the global compaction:
                # a stable sort of each row by (column if a pair, else w)
                k2 = 64
                key = torch.where(mask, torch.arange(w, device=dev)[None], w)
                key_s, perm = torch.sort(key, dim=-1, stable=True)
                mask = key_s[:, :k2] < w
                cb = torch.gather(cb, 1, perm[:, :k2])
                ca = ca[:, :k2]
            ca, cb, mask = (a.reshape(-1) for a in (ca, cb, mask))
        else:
            ar = torch.arange(n, device=dev)
            ca = ar[:, None].expand(n, n).reshape(-1)
            cb = ar[None, :].expand(n, n).reshape(-1)
            mask = self._pair_mask_of(ca, cb, cur, cp_x0, cp_obj_ids, radius,
                                      cp_exclude=cp_exclude)
            num_pairs = mask.sum()
            diag = {"num_pairs": num_pairs,
                    "contacts_overflow": num_pairs > self.max_contacts}
        flat_idx = nonzero_static(mask, self.max_contacts)
        valid = flat_idx >= 0
        safe = torch.where(valid, flat_idx, 0)
        return ca[safe], cb[safe], valid, diag

    def detection_diagnostics(self, cp_dx, cp_x0, cp_obj_ids,
                              cp_is_static=None, cp_exclude=None):
        """Capacity overflow at this configuration: ``num_pairs`` (the true
        pair count), ``contacts_overflow``, and per phase — grid:
        ``cell_overflow``/``dropped_points``/``max_cell_occupancy``,
        ``occ_overflow``/``num_occupied``, ``pp_overflow``/
        ``pp_dropped_pairs``, ``out_of_bounds``; sweep:
        ``max_window_load``/``window_overflow``. 0-dim tensors."""
        n = cp_x0.shape[0]
        if cp_is_static is None:
            cp_is_static = torch.zeros((n,), dtype=torch.int32,
                                       device=cp_x0.device)
        cur = cp_dx + cp_x0
        return self._flat_pairs(cur, cp_x0, cp_obj_ids, cp_is_static,
                                cp_exclude=cp_exclude)[3]

    @staticmethod
    def _fetch_rows(table, idx):
        """``table[idx]``. (The JAX package's one-hot product is a TPU
        strategy; on other backends it takes this gather.)"""
        return table[idx]

    # -- detection --
    def detect_collisions(self, cp_dx, cp_x0, cp_obj_ids, cp_is_static=None,
                          weights=None, cp_exclude=None, return_diag=False):
        """Find contact pairs → a :class:`Contacts` buffer of
        ``max_contacts`` entries, and with ``return_diag`` this detection's
        :meth:`detection_diagnostics` dict too.

        cp_dx (N, 3) current displacements; cp_x0 (N, 3) rest positions;
        cp_obj_ids (N,) int; cp_is_static (N,) int {0, 1}; weights (N, H)
        global skinning weights — with them the contacts carry the q-form
        factors, without them ``dx0`` for the gather form; cp_exclude (N,)
        bool leaves points out of detection. Reads nothing back to the
        host."""
        n = cp_x0.shape[0]
        if cp_is_static is None:
            cp_is_static = torch.zeros((n,), dtype=torch.int32,
                                       device=cp_x0.device)
        cur = cp_dx + cp_x0
        ia, ib, valid, diag = self._flat_pairs(cur, cp_x0, cp_obj_ids,
                                               cp_is_static,
                                               cp_exclude=cp_exclude)

        # a static partner always sits on side b: rc and the offset are
        # asymmetric in (a, b)
        swap = (cp_is_static[ia] == 1) & (cp_is_static[ib] == 0)
        ia, ib = torch.where(swap, ib, ia), torch.where(swap, ia, ib)

        chans = [cur, cp_x0, cp_is_static.to(cur.dtype)[:, None]]
        if weights is not None:
            chans.append(weights.to(cur.dtype))
        table = torch.cat(chans, 1)
        both = self._fetch_rows(table, torch.cat([ia, ib])).T
        c = ia.shape[0]
        ra, rb = both[:, :c], both[:, c:]                        # (ch, C)

        pos_a, pos_b = ra[0:3], rb[0:3]
        stat_a = ra[6] > 0.5
        stat_b = rb[6] > 0.5
        diff = pos_a - pos_b                                     # (3, C)
        length = torch.sqrt(diff[0] * diff[0] + diff[1] * diff[1]
                            + diff[2] * diff[2])
        nrm = diff / torch.clamp(length, min=1e-12)[None]
        # the offset is zero at detection
        gaps = (diff[0] * nrm[0] + diff[1] * nrm[1]
                + diff[2] * nrm[2])[None] * nrm

        a_on = valid & ~stat_a
        b_on = valid & ~stat_b
        indices_a = torch.where(a_on, ia, NULL)
        indices_b = torch.where(b_on, ib, NULL)
        if weights is not None:
            one = torch.ones_like(ra[:1])
            wa = torch.where(a_on[None], ra[7:], 0.0).T
            wb = torch.where(b_on[None], rb[7:], 0.0).T
            xa = torch.cat([ra[3:6], one], 0).T
            xb = torch.cat([rb[3:6], one], 0).T
            qat = _q_factor_t(wa, xa)
            qbt = _q_factor_t(wb, xb)
            dx0 = None
        else:
            wa = wb = xa = xb = qat = qbt = None
            dx0 = cp_dx
        contacts = Contacts(indices_a=indices_a, indices_b=indices_b,
                            normals=nrm.T, kinematic_gaps=gaps.T, valid=valid,
                            dx0=dx0, wa=wa, wb=wb, xa=xa, xb=xb,
                            qat=qat, qbt=qbt)
        if return_diag:
            return contacts, diag
        return contacts

    # -- per-contact geometry, channels first ((3, C)) --
    def _offset_rc_t(self, contacts: Contacts, dx=None, zq=None):
        """Relative offset (3, C) and target distance rc (C,). ``zq`` (D,)
        raw-basis DOF change since detection (q-form), or ``dx`` (N, 3)
        current displacements (gather form, needs ``contacts.dx0``)."""
        ia = contacts.indices_a
        ib = contacts.indices_b
        if zq is not None:
            z2t = _z_mat(zq).T                                   # (3, 4H)
            qat, qbt = self._q_sides(contacts)
            delta_a = z2t @ qat                                  # (3, C)
            delta_b = z2t @ qbt
        else:
            sa = torch.where(ia != NULL, ia, 0)
            sb = torch.where(ib != NULL, ib, 0)
            delta_a = torch.where((ia != NULL)[None],
                                  (dx[sa] - contacts.dx0[sa]).T, 0.0)
            delta_b = torch.where((ib != NULL)[None],
                                  (dx[sb] - contacts.dx0[sb]).T, 0.0)
        offset = delta_a + contacts.kinematic_gaps.T - delta_b
        rc = torch.where(ib == NULL, 1.0, 2.0) * self.collision_radius
        return offset, rc.to(offset.dtype)

    def _offset_rc(self, contacts: Contacts, dx=None, zq=None):
        """Row layout: offset (C, 3), rc (C, 1)."""
        offset, rc = self._offset_rc_t(contacts, dx=dx, zq=zq)
        return offset.T, rc[:, None]

    def _barrier_terms(self, contacts, dx=None, zq=None):
        """offset, nor, vt (3, C); the rest (C,)."""
        offset, rc = self._offset_rc_t(contacts, dx=dx, zq=zq)
        nor = contacts.normals.T                                 # (3, C)
        d = (offset * nor).sum(0)
        d_hat = d / rc
        rp = self.collision_barrier_ratio
        active = (d_hat > rp) & (d_hat <= 1.0) & contacts.valid
        dp = torch.clamp(d_hat - rp, min=1e-9)   # a safe log where inactive
        dc = d_hat - 1.0
        barrier = 2.0 * torch.log(dp)
        dE_d_hat = -dc * (barrier + dc / dp)
        vt = (offset - d[None] * nor) / self.dt                  # (3, C)
        vt_norm = torch.sqrt((vt * vt).sum(0))
        return (offset, rc, nor, d, d_hat, active, dp, dc, barrier, dE_d_hat,
                vt, vt_norm)

    def _h_vt(self, vt_norm):
        nu = self.friction_fluid
        return (0.5 * nu * vt_norm ** 2
                + torch.where(vt_norm < 1.0,
                              vt_norm ** 2 * (1.0 - vt_norm / 3.0),
                              vt_norm - 1.0 / 3.0))

    def energy(self, contacts: Contacts, dx=None, coeff=1.0, zq=None):
        (offset, rc, nor, d, d_hat, active, dp, dc, barrier, dE_d_hat,
         vt, vt_norm) = self._barrier_terms(contacts, dx=dx, zq=zq)
        mu = self.friction
        e = -(dc ** 2) * torch.log(dp)
        mu_fn = -mu * dE_d_hat / rc
        e = e + mu_fn * self.dt * self._h_vt(vt_norm)
        return coeff * torch.where(active, e, 0.0).sum()

    def gradient(self, contacts: Contacts, dx=None, coeff=1.0, zq=None):
        """dE/d(offset) per contact → (C, 3)."""
        (offset, rc, nor, d, d_hat, active, dp, dc, barrier, dE_d_hat,
         vt, vt_norm) = self._barrier_terms(contacts, dx=dx, zq=zq)
        mu = self.friction
        nu = self.friction_fluid
        g = (dE_d_hat / rc)[None] * nor                          # (3, C)
        mu_fn = -mu * dE_d_hat / rc
        f1_over = torch.where(vt_norm < 1.0, 2.0 - vt_norm,
                              1.0 / torch.clamp(vt_norm, min=1e-12))
        g = g + (mu_fn * (f1_over + nu))[None] * vt
        h_vt = self._h_vt(vt_norm)
        dbarrier = 2.0 / dp
        ddcdp = (dp - dc) / (dp * dp)
        d2E = -(barrier + dc / dp) - dc * (dbarrier + ddcdp)
        g = g + (-mu * self.dt * h_vt * d2E / (rc * rc))[None] * nor
        return coeff * torch.where(active[None], g, 0.0).T

    def hessian(self, contacts: Contacts, dx=None, coeff=1.0, zq=None):
        """d²E/d(offset)² per contact → (C, 3, 3)."""
        (offset, rc, nor, d, d_hat, active, dp, dc, barrier, dE_d_hat,
         vt, vt_norm) = self._barrier_terms(contacts, dx=dx, zq=zq)
        mu = self.friction
        nu = self.friction_fluid
        dt = self.dt
        rc2 = rc * rc

        def b(s):   # (C,) → (1, 1, C)
            return s[None, None]

        dbarrier = 2.0 / dp
        ddcdp = (dp - dc) / (dp * dp)
        d2E = -(barrier + dc / dp) - dc * (dbarrier + ddcdp)
        nn = nor[:, None] * nor[None]                            # (3, 3, C)
        h = b(d2E / rc2) * nn

        mu_fn = -mu * dE_d_hat / rc
        mu_fn_p = -mu * d2E / rc
        f1_over = torch.where(vt_norm < 1.0, 2.0 - vt_norm,
                              1.0 / torch.clamp(vt_norm, min=1e-12))
        f1_nu = f1_over + nu
        eye = torch.eye(3, dtype=nor.dtype, device=nor.device)[:, :, None]
        tangent_proj = eye - nn
        eps = 1e-4
        vv = vt[:, None] * vt[None]                              # (3, 3, C)

        near_zero = vt_norm < eps
        stick = (vt_norm >= eps) & (vt_norm < 1.0)
        vt_safe = torch.clamp(vt_norm, min=eps)
        h_nz = b(mu_fn / dt * f1_nu) * tangent_proj
        h_stick = b(mu_fn / dt) * (
            b(f1_nu) * tangent_proj - vv / b(vt_safe * dt))
        f1_p = -1.0 / (vt_safe ** 2)
        h_slip = b(mu_fn) * (
            b(f1_p / (vt_safe * dt)) * vv + b(f1_nu / dt) * tangent_proj)
        h = h + torch.where(b(near_zero), h_nz,
                            torch.where(b(stick), h_stick, h_slip))
        h = h + b(mu_fn_p * f1_nu / rc) * (vt[:, None] * nor[None])

        h_vt = self._h_vt(vt_norm)
        h_vt_p = torch.where(vt_norm < 1.0,
                             nu * vt_norm + 2.0 * vt_norm - vt_norm ** 2,
                             nu * vt_norm + 1.0)
        d2barrier = -2.0 / (dp * dp)
        dddcdp = -2.0 * ddcdp / dp
        df = dbarrier - dc / (dp * dp)
        dg = d2barrier + dddcdp
        d3E = -df - dg * dc - (dbarrier + ddcdp)
        dvtn = torch.where((vt_norm > eps)[None], vt / (vt_safe * dt)[None],
                           0.0)                                  # (3, C)
        chain = b(-mu * dt / rc2)
        h = h + chain * (
            b(d2E * h_vt_p) * (nor[:, None] * dvtn[None])
            + b(h_vt * d3E / rc) * nn)
        h = coeff * torch.where(b(active), h, 0.0)
        return h.permute(2, 0, 1)

    # -- q-form pullbacks: Jᵀg and JᵀHJ without J --
    @staticmethod
    def _q_sides(contacts: Contacts):
        """Per-side (4H, C) factors: those made at detection, or rebuilt
        from (w, x) for a buffer built by hand."""
        if contacts.qat is not None:
            return contacts.qat, contacts.qbt
        return (_q_factor_t(contacts.wa, contacts.xa),
                _q_factor_t(contacts.wb, contacts.xb))

    @staticmethod
    def _q_diff(contacts: Contacts):
        qat, qbt = Collision._q_sides(contacts)
        return (qat - qbt).T                                     # (C, 4H)

    def pullback_gradient(self, contacts: Contacts, g_per_contact):
        """Raw-basis DOF gradient (D,) = Σ_c J_cᵀ g_c:
        grad[(h, r, s)] = Σ_c q_c[h, s] g_c[r]."""
        q = self._q_diff(contacts)
        g2 = q.T @ g_per_contact                                 # (4H, 3)
        h = q.shape[1] // 4
        return g2.reshape(h, 4, 3).transpose(1, 2).reshape(-1)

    def reduced_hessian(self, contacts: Contacts, h_per_contact):
        """Raw-basis (D, D) JᵀHJ: JHJ[(h,r,s),(h',r',s')] =
        Σ_c q_c[h,s] H_c[r,r'] q_c[h',s'], nine (4H, C) @ (C, 4H)
        products."""
        q = self._q_diff(contacts)
        h4 = q.shape[1]
        h = h4 // 4
        x = torch.stack([torch.stack([(q * h_per_contact[:, r, c, None]).T
                                      @ q for c in range(3)])
                         for r in range(3)])                     # (3,3,4H,4H)
        x = x.reshape(3, 3, h, 4, h, 4).permute(2, 0, 3, 4, 1, 5)
        return x.reshape(12 * h, 12 * h)

    # -- line-search bounds → (D,) per-DOF step clamp --
    def get_bounds_q(self, contacts: Contacts, dzq, zq):
        """Per-DOF Armijo step clamp in the raw basis: ``dzq`` (D,) the
        Newton direction, ``zq`` (D,) the DOF change since detection."""
        nor_t = contacts.normals.T                               # (3, C)
        dz2t = _z_mat(dzq).T                                     # (3, 4H)
        qa_t, qb_t = self._q_sides(contacts)                     # (4H, C)
        delta_d_a = (nor_t * (dz2t @ qa_t)).sum(0)
        delta_d_b = -(nor_t * (dz2t @ qb_t)).sum(0)

        offset_t, rc = self._offset_rc_t(contacts, zq=zq)
        rp = self.collision_barrier_ratio * rc
        gap_cur = rp - (offset_t * nor_t).sum(0)
        ok = (gap_cur < 0.0) & contacts.valid
        max_delta_d = 0.5 * 0.75 * gap_cur

        def tmax(delta_d):
            closing = (delta_d < 0.0) & ok
            t = torch.clamp(max_delta_d / torch.where(closing, delta_d, -1.0),
                            0.0, 1.0)
            return torch.where(closing, t, 1.0)

        t_a = tmax(delta_d_a)
        t_b = tmax(delta_d_b)
        b_a = torch.where(qa_t != 0.0, t_a[None], 1.0).amin(1)
        b_b = torch.where(qb_t != 0.0, t_b[None], 1.0).amin(1)
        b4 = torch.minimum(b_a, b_b)                             # (4H,)
        h = b4.shape[0] // 4
        return b4.reshape(h, 1, 4).expand(h, 3, 4).reshape(-1)

    def get_bounds(self, contacts: Contacts, delta_dx, dx, ja_raw, jb_raw):
        """Gather-form bounds from explicit raw contact jacobians (the scene
        uses :meth:`get_bounds_q`)."""
        d = ja_raw.shape[1]
        c = contacts.normals.shape[0]
        nor = contacts.normals
        ia, ib = contacts.indices_a, contacts.indices_b
        sa = torch.where(ia != NULL, ia, 0)
        sb = torch.where(ib != NULL, ib, 0)
        delta_d_a = torch.where(ia != NULL, (nor * delta_dx[sa]).sum(-1),
                                0.0)
        delta_d_b = torch.where(ib != NULL, -(nor * delta_dx[sb]).sum(-1),
                                0.0)

        offset, rc = self._offset_rc(contacts, dx=dx)
        rp = self.collision_barrier_ratio * rc[:, 0]
        gap_cur = rp - (offset * nor).sum(-1)
        ok = (gap_cur < 0.0) & contacts.valid
        max_delta_d = 0.5 * 0.75 * gap_cur

        def tmax(delta_d):
            closing = (delta_d < 0.0) & ok
            t = torch.clamp(max_delta_d / torch.where(closing, delta_d, -1.0),
                            0.0, 1.0)
            return torch.where(closing, t, 1.0)

        t_a = tmax(delta_d_a)
        t_b = tmax(delta_d_b)
        mask_a = (ja_raw.reshape(c, 3, d) != 0.0).any(1)
        mask_b = (jb_raw.reshape(c, 3, d) != 0.0).any(1)
        bounds = torch.where(mask_a, t_a[:, None], 1.0).amin(0)
        return torch.minimum(
            bounds, torch.where(mask_b, t_b[:, None], 1.0).amin(0))

    def calculate_jacobian(self, contacts: Contacts, B_dense, qr_tfm=None):
        """The dense contact jacobian J = J_a − J_b (3C, D), with J_a and J_b
        (the scene never forms it; see :meth:`pullback_gradient`)."""
        d = B_dense.shape[1]

        def side(idx):
            ok = idx != NULL
            safe = torch.where(ok, idx, 0)
            rows = B_dense.reshape(-1, 3, d)[safe]               # (C, 3, D)
            return torch.where(ok[:, None, None], rows, 0.0)

        v = contacts.valid[:, None, None].to(B_dense.dtype)
        ja = side(contacts.indices_a) * v
        jb = side(contacts.indices_b) * v
        j = (ja - jb).reshape(-1, d)
        if qr_tfm is not None:
            j = j @ qr_tfm
        return j, ja.reshape(-1, d), jb.reshape(-1, d)
