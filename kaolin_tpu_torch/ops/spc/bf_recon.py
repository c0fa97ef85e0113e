"""Bayesian-Fusion reconstruction of 3-state octrees from calibrated RGBD.

Counterpart of ``kaolin_tpu/ops/spc/bf_recon.py`` (reference
``kaolin/ops/spc/bf_recon.py:27-429`` and the CUDA kernels of
``bf_cuda.cu``/``recon_cuda.cu``). Algorithm (3DV 2016, "A Closed-Form
Bayesian Fusion Equation Using Occupancy Probabilities"): each calibrated
depth map is carved into an octree whose leaves carry occupancy
probabilities from a quadratic-B-spline noise profile; a voxel is one of
{0: observed-empty, 1: unseen, 2: occupied}. The octree is a pair of byte
tensors ``(octree, empty)``: octree bit set → occupied; empty bit set
(octree clear) → unseen; both clear → known empty. Frames fuse pairwise
with the closed-form probability product.

The per-voxel math (projection, mip interval tests, the profile curve,
the fusion) runs on the device of the frame's depth map (the octree's);
the coarse-to-fine subdivision and the bottom-up byte assembly run on the
host in numpy, one read of each level's states, as in the JAX package.
The arithmetic is XLA's without contraction into fused multiply-adds: a
corner's projection sums its four products pairwise, as XLA's dot does,
and every product and sum is its own op, so the card and the CPU agree bit
for bit and the integer states equal the JAX package's compiled without
its optimizations. The JAX package pads every per-voxel call to a power of
two to bound its recompiles; nothing here is padded.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import host, morton_to_points
from kaolin_tpu_torch.ops.spc.spc import popcount_table, scan_octrees

__all__ = [
    "build_mip2d",
    "bf_recon",
    "process_frame",
    "fuse_bf",
    "extract_bq",
    "unbatched_query",
    "bq_profile",
    "dbq_profile",
]

_NEAR_CLIPPING = 0.15

# Bezier ordinates of the quadratic-B-spline CDF profile curve, packed as
# little-endian uchar4 per segment (bf.cpp SetupProfileCurve :150-163).
_BPS_VALS = np.array([
    0x02000000, 0x10080402, 0x30241810, 0x4f483c30, 0x5658564f,
    0x484e5456, 0x383c4248, 0x31323438, 0x30303031], dtype=np.uint32)
_BPS_TABLE = np.stack([(_BPS_VALS >> s) & 0xFF for s in (0, 8, 16, 24)],
                      axis=-1).astype(np.float32) / 255.0
_PC_SCALE = 2.65625  # 255/96

_CORNER_OFFS = np.array([[i >> 2, (i >> 1) & 1, i & 1] for i in range(8)],
                        dtype=np.int32)


def _segment(x):
    """The profile's Bezier segment of ``x``: (t, 1 − t, its 4 ordinates)."""
    table = torch.from_numpy(_BPS_TABLE).to(x.device)
    u = x + 3.0
    iu = torch.clamp(torch.trunc(u), 0, 8).to(torch.int32)
    t = torch.clamp(u - iu, 0.0, 1.0)
    return t, 1.0 - t, table[iu.long()]


def bq_profile(x):
    """Bayesian-fusion profile curve (occupancy probability vs normalized
    signed distance). 0 for x<=-3, 0.5 for x>=6, cubic Bezier between.
    Kernel BQ, bf_cuda.cu:45."""
    x = torch.as_tensor(x)
    t, s, c = _segment(x)
    val = _PC_SCALE * (s * s * (s * c[..., 0] + 3 * t * c[..., 1])
                       + t * t * (3 * s * c[..., 2] + t * c[..., 3]))
    return torch.where(x <= -3.0, 0.0, torch.where(x >= 6.0, 0.5, val))


def dbq_profile(x):
    """Derivative of the profile curve (de Casteljau). Kernel DBQ :71."""
    x = torch.as_tensor(x)
    t, s, c = _segment(x)
    c10 = s * c[..., 0] + t * c[..., 1]
    c11 = s * c[..., 1] + t * c[..., 2]
    c12 = s * c[..., 2] + t * c[..., 3]
    c20 = s * c10 + t * c11
    c21 = s * c11 + t * c12
    val = _PC_SCALE * 3.0 * (c21 - c20)
    return torch.where((x <= -3.0) | (x >= 6.0), 0.0, val)


def build_mip2d(depth_map, intrinsics, mip_levels, max_depth, true_depth=True):
    """Depth min/max mip pyramid. Ref recon_cuda.cu:149 (build_mip2d).

    Args:
        depth_map: (H, W) float ray depths (or z-depths if not true_depth),
            a tensor (its device is used) or an array (the CPU).
        intrinsics: (4, 4) camera intrinsic matrix (row-vector convention:
            fx=In[0,0], fy=In[1,1], cx=In[2,0], cy=In[2,1]).
        mip_levels: number of pyramid levels.
        max_depth: sentinel for missed rays (kept unscaled).
        true_depth: if True, convert ray depth → z-depth via the per-pixel
            1/sqrt(u²+v²+1) factor before mipping. JAX's ``rsqrt`` becomes
            ``1 / sqrt``, correctly rounded on the card and the CPU alike
            (``torch.rsqrt`` on the card is CUDA's approximate one).

    Returns:
        (adjusted_depth (H, W), mips): ``mips[l]`` for l=0..mip_levels-1 is
        (H/2^(l+1), W/2^(l+1), 2) with [min, max] per texel.
    """
    depth_map = torch.as_tensor(depth_map).to(torch.float32)
    h, w = depth_map.shape
    intrinsics = np.asarray(host(intrinsics), dtype=np.float32)
    fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
    cx, cy = float(intrinsics[2, 0]), float(intrinsics[2, 1])
    device = depth_map.device

    if true_depth:
        xs = (torch.arange(w, dtype=torch.float32, device=device) - cx) / fx
        ys = (torch.arange(h, dtype=torch.float32, device=device) - cy) / fy
        u, v = torch.meshgrid(xs, ys, indexing="xy")
        scale = 1.0 / torch.sqrt(u * u + v * v + 1.0)
        depth_map = torch.where(depth_map == max_depth, depth_map,
                                depth_map * scale)

    mips = []
    cur_min = cur_max = depth_map
    for _ in range(mip_levels):
        hh, ww = cur_min.shape
        mn = cur_min.reshape(hh // 2, 2, ww // 2, 2).amin(dim=(1, 3))
        mx = cur_max.reshape(hh // 2, 2, ww // 2, 2).amax(dim=(1, 3))
        mips.append(torch.stack([mn, mx], dim=-1))
        cur_min, cur_max = mn, mx
    return depth_map, tuple(mips)


def _camera_T(cam, level, device):
    """T = M(level) @ Cam: voxel integer coords → pixel-homogeneous
    (row-vector convention), computed on the host in float32 as the JAX
    package does. bf.cpp:247-253."""
    scale = 2.0 / (2.0 ** level)
    m = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    m[3, :3] = -1.0
    t = m @ np.asarray(host(cam), dtype=np.float32)
    return torch.from_numpy(t).to(device)


def _homogeneous(pts, t_mat):
    """[p, 1] @ T for float32 points (N, 3): the four products summed
    pairwise, as XLA's dot sums them."""
    return ((pts[:, 0:1] * t_mat[0] + pts[:, 1:2] * t_mat[1])
            + (pts[:, 2:3] * t_mat[2] + t_mat[3]))


def _transform_corners(points, t_mat):
    """(N, 3) int voxel coords → (N, 8, 3) pixel-space (x, y, z) of the 8
    corners, corner order i=(x<<2|y<<1|z). spc_math.h:485 (but projected)."""
    base = _homogeneous(points.to(t_mat.dtype), t_mat)
    offs = torch.from_numpy(_CORNER_OFFS).to(t_mat)
    # corner offsets as sums over the three axes, in order (exact products)
    steps = (offs[:, 0:1] * t_mat[0] + offs[:, 1:2] * t_mat[1]) \
        + offs[:, 2:3] * t_mat[2]
    corners = base[:, None, :] + steps[None]                   # (N, 8, 4)
    z = corners[..., 2]
    return torch.stack([corners[..., 0] / z, corners[..., 1] / z, z], dim=-1)


def _flat_mips(depth_map, mips):
    """Level 0 (the full-res depth as min = max) and the mips as one (T, 2)
    buffer → (buffer, per-level offsets, per-level strides), int64."""
    h, w = depth_map.shape
    flats = [torch.stack([depth_map, depth_map], -1).reshape(-1, 2)]
    offsets, strides, acc = [0], [w], flats[0].shape[0]
    for m in mips:
        offsets.append(acc)
        strides.append(m.shape[1])
        flats.append(m.reshape(-1, 2))
        acc += flats[-1].shape[0]
    device = depth_map.device
    return (torch.cat(flats, dim=0), torch.tensor(offsets, device=device),
            torch.tensor(strides, device=device))


def _oracle_b(points, level, sigma, cam, depth_map, mips):
    """Voxel visibility classification against the depth mip. Kernel
    d_OracleB (bf_cuda.cu:129) → (occupancies, states) int32 on the
    points' device."""
    h, w = depth_map.shape
    mip_levels = len(mips)
    mips_flat, mip_offsets, mip_strides = _flat_mips(depth_map, mips)
    q = _transform_corners(points, _camera_T(cam, level, points.device))
    mn = q.amin(dim=1)
    mx = q.amax(dim=1)

    fully_in = ((mn[:, 0] >= 0.0) & (mx[:, 0] < w) & (mn[:, 1] >= 0.0)
                & (mx[:, 1] < h) & (mn[:, 2] > _NEAR_CLIPPING))
    fully_out = ((mx[:, 0] < 0.0) | (mn[:, 0] > w) | (mx[:, 1] < 0.0)
                 | (mn[:, 1] > h) | (mx[:, 2] < _NEAR_CLIPPING))

    ext = torch.maximum(mx[:, 0] - mn[:, 0], mx[:, 1] - mn[:, 1])
    miplevel = torch.clamp(torch.ceil(torch.log2(torch.clamp(ext,
                                                             min=1e-20))),
                           min=0.0).to(torch.int32)
    ml = torch.clamp(miplevel, 0, mip_levels).long()
    adapt_inv = torch.exp2(-ml.to(torch.float32))

    xmin = (adapt_inv * mn[:, 0]).to(torch.int32)
    ymin = (adapt_inv * mn[:, 1]).to(torch.int32)
    xmax = (adapt_inv * mx[:, 0]).to(torch.int32)
    ymax = (adapt_inv * mx[:, 1]).to(torch.int32)
    stride = mip_strides[ml]
    off = mip_offsets[ml]

    def texel(yy, xx):
        idx = off + yy * stride + xx
        return mips_flat[torch.clamp(idx, 0, mips_flat.shape[0] - 1)]

    d00 = texel(ymin, xmin)
    d10 = texel(ymin, xmax)
    d01 = texel(ymax, xmin)
    d11 = texel(ymax, xmax)
    z0 = torch.minimum(torch.minimum(d00[:, 0], d10[:, 0]),
                       torch.minimum(d01[:, 0], d11[:, 0])) - sigma
    z1 = torch.maximum(torch.maximum(d00[:, 1], d10[:, 1]),
                       torch.maximum(d01[:, 1], d11[:, 1])) + 2.0 * sigma
    v0 = mn[:, 2]
    v1 = mx[:, 2]

    in_band = (z0 <= v1) & (v0 <= z1)
    state_in = torch.where(z0 > v1, 0, torch.where(z1 < v0, 1, 2))
    too_high = miplevel > mip_levels
    occ_in = torch.where(too_high, 1, in_band.to(torch.int32))
    state_in = torch.where(too_high, 2, state_in)

    occ = torch.where(fully_in, occ_in, torch.where(fully_out, 0, 1))
    state = torch.where(fully_in, state_in, torch.where(fully_out, 1, 2))
    return occ.to(torch.int32), state.to(torch.int32)


def _oracle_b_final(points, level, sigma, cam, depth_map):
    """Final-level probability classification. Kernel d_OracleBFinal :260
    → (occupancies, states, probabilities of corner 0)."""
    h, w = depth_map.shape
    q = _transform_corners(points, _camera_T(cam, level, points.device))
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    inb = (x >= 0.0) & (x < w) & (y >= 0.0) & (y < h) & (z > _NEAR_CLIPPING)
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    d = depth_map[yi, xi]
    prob = torch.where(inb, bq_profile((3.0 / float(sigma)) * (z - d)), 0.5)
    pmin = prob.amin(dim=1)
    pmax = prob.amax(dim=1)
    empty = pmax == 0.0
    unseen = (pmin == 0.5) & (pmax == 0.5)
    occ = torch.where(empty | unseen, 0, 1).to(torch.int32)
    state = torch.where(empty, 0, torch.where(unseen, 1, 2)).to(torch.int32)
    return occ, state, prob[:, 0]


def _colors_b_final(points, level, cam, sigma, image, depth_map, probs):
    """Per-voxel color + depth-gradient normal. Kernel d_ColorsBFinal :407."""
    h, w = depth_map.shape
    t_mat = _camera_T(cam, level, points.device)
    one_over_sigma = 3.0 / float(sigma)
    base = _homogeneous(points.to(t_mat.dtype), t_mat)
    qx = base[:, 0] / base[:, 2]
    qy = base[:, 1] / base[:, 2]
    qz = base[:, 2]
    x = qx.to(torch.int32)
    y = qy.to(torch.int32)
    inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1) \
        & (qz > _NEAR_CLIPPING)
    xs = torch.clamp(x, 1, w - 2).long()
    ys = torch.clamp(y, 1, h - 2).long()

    color = image[ys, xs]  # (N, 3) rgb in [0,1]
    d00 = depth_map[ys, xs]
    du = 0.5 * (depth_map[ys, xs + 1] - depth_map[ys, xs - 1])
    dv = 0.5 * (depth_map[ys + 1, xs] - depth_map[ys - 1, xs])
    dprob = dbq_profile(one_over_sigma * (qz - d00))
    zi = 1.0 / qz
    wgt = one_over_sigma * dprob * zi
    hx = -wgt * du
    hy = -wgt * dv
    hz = wgt * zi * (qz * qz + base[:, 0] * du + base[:, 1] * dv)
    # f = T * h (column vector, the fourth entry 0), kernel :483
    grad = ((t_mat[:3, 0] * hx[:, None] + t_mat[:3, 1] * hy[:, None])
            + t_mat[:3, 2] * hz[:, None])
    norm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    normal = grad / torch.where(norm > 0, norm, 1.0)

    valid = inb & (probs != 0.0) & (probs != 0.5)
    gray = inb & (probs == 0.5)
    bgr = torch.stack([color[:, 2], color[:, 1], color[:, 0],
                       torch.zeros_like(color[:, 0])], dim=-1)
    u8 = torch.uint8
    colors_u8 = torch.where(valid[:, None], (255.0 * bgr).to(u8),
                            torch.where((gray | ~inb)[:, None], 64, 0).to(u8))
    zero_col = inb & (probs == 0.0)
    colors_u8 = torch.where(zero_col[:, None], 0, colors_u8).to(u8)
    normals = torch.where(valid[:, None], normal, 0.0)
    return colors_u8, normals


# ---------------------------------------------------------------------------
# 3-state octree walk
# ---------------------------------------------------------------------------

def identify_empty(octree, empty, exsum, coords, level):
    """Empty-aware octree walk (spc_utils.cuh:106): index >= 0 for occupied
    leaves, -1 for observed-empty space, -2-depth for unseen space (depth is
    the level below which the walk stopped). On the coords' device, no
    host read."""
    coords = coords.to(torch.int32)
    device = coords.device
    octree = octree.to(device)
    empty_t = empty.to(device)
    exsum = exsum.to(device, torch.int32)
    popc = popcount_table(device)
    n = coords.shape[0]
    res = 2 ** level
    in_bounds = torch.all((coords >= 0) & (coords < res), dim=-1)

    ord_ = torch.zeros((n,), dtype=torch.int32, device=device)
    result = torch.where(in_bounds, -(2 ** 30), -1).to(torch.int32)
    done = ~in_bounds
    for lv in range(1, level + 1):
        shift = level - lv
        o = (((coords[:, 0] >> shift) & 1) * 4
             + ((coords[:, 1] >> shift) & 1) * 2
             + ((coords[:, 2] >> shift) & 1))
        idx = ord_.long()
        byte = octree[idx].to(torch.int32)
        ebyte = empty_t[idx].to(torch.int32)
        has_child = ((byte >> o) & 1) == 1
        below = byte & ((1 << o) - 1)
        base = torch.where(ord_ > 0, exsum[torch.clamp(idx - 1, min=0)], 0)
        child = base + popc[below.long()] + 1
        miss_val = torch.where(((ebyte >> o) & 1) == 1, -2 - shift, -1)
        result = torch.where(~done & ~has_child, miss_val, result)
        done = done | ~has_child
        ord_ = torch.where(~done, child, ord_).to(torch.int32)
    return torch.where(~done, ord_, result).to(torch.int32)


def unbatched_query(octree, empty, exsum, query_coords, level):
    """3-state query: returns hierarchy index if occupied, -1 if outside
    (observed empty), < -1 if inside/unseen. Ref bf_recon.py:388."""
    query_coords = torch.as_tensor(query_coords)
    if query_coords.is_floating_point():
        coords = torch.floor((query_coords + 1.0) * (2 ** level / 2.0)) \
            .to(torch.int32)
    else:
        coords = query_coords.to(torch.int32)
    return identify_empty(octree, empty, exsum, coords, level)


# ---------------------------------------------------------------------------
# bottom-up assembly (host): process_final_voxels + compactify_nodes
# ---------------------------------------------------------------------------

def _assemble(states, occ_idx, level):
    """Bottom-up build of (octree, empty) bytes from per-level voxel states
    (host numpy).

    states[l]: (N_l,) int {0 empty, 1 unseen, 2 occupied} for enumerated
    voxels at level l (8 children per occupied level-(l-1) voxel, in order;
    level 0 has the single root). occ_idx[l]: indices into states[l] of the
    voxels that were subdivided (spawned the level-(l+1) groups).

    Kernel d_ProcessFinalVoxels (bf_cuda.cu:348) + compactify_nodes.
    Mutates states (parent promotion/demotion), returns (octree, empty).
    """
    oct_bytes = [None] * level   # bytes for nodes at levels 0..level-1
    emp_bytes = [None] * level
    keep_parent = [None] * level
    for l in range(level, 0, -1):
        s = states[l].reshape(-1, 8)          # (K, 8), K = len(occ_idx[l-1])
        bits = (s == 2).astype(np.uint8)
        ebits = (s >= 1).astype(np.uint8)
        weights = (1 << np.arange(8, dtype=np.uint8))
        ob = (bits * weights).sum(axis=1).astype(np.uint8)
        eb = (ebits * weights).sum(axis=1).astype(np.uint8)
        node_occ = bits.any(axis=1)
        parent_state = np.where(node_occ, 2, np.where(eb > 0, 1, 0))
        states[l - 1][occ_idx[l - 1]] = parent_state
        oct_bytes[l - 1] = ob
        emp_bytes[l - 1] = eb
        keep_parent[l - 1] = occ_idx[l - 1]
    # keep a node's byte iff its parent voxel is (still) occupied
    out_o, out_e = [], []
    for l in range(level):
        keep = states[l][keep_parent[l]] == 2
        out_o.append(oct_bytes[l][keep])
        out_e.append(emp_bytes[l][keep])
    return np.concatenate(out_o), np.concatenate(out_e)


def _child_points(points, occ):
    """Subdivide occupied voxels → children at next level (morton order) +
    parent indices (host numpy). CUDA subdivide."""
    occ_idx = np.nonzero(occ)[0]
    parents = points[occ_idx]
    children = (2 * parents[:, None, :]
                + _CORNER_OFFS.astype(points.dtype)[None]).reshape(-1, 3)
    return children, occ_idx


class BFReconstructionTerminatedException(Exception):
    """Raised internally when fusion degenerates (no occupied voxels)."""


def _start_states(start_level):
    """Every voxel above ``start_level`` occupied and subdivided."""
    states = [np.full((8 ** l,), 2, dtype=np.int32)
              for l in range(start_level)]
    occ_idx = [np.arange(8 ** l, dtype=np.int64) for l in range(start_level)]
    return states, occ_idx


def _finalize(states, occ_idx, level, probs, colors, normals):
    """The 3-state SPC dict of one frame or fusion: octree, empty, exsum,
    pyramid and the occupied leaves' probabilities, colors and normals as
    tensors on the device of ``probs``; ``level`` an int."""
    final_keep = torch.from_numpy(states[level] == 2).to(probs.device)
    octree, empty = _assemble(states, occ_idx, level)
    if octree.size == 0 or int(octree[0]) == 0:
        raise BFReconstructionTerminatedException()
    octree = torch.from_numpy(octree).to(probs.device)
    out_level, pyramid, exsum = scan_octrees(
        octree, torch.tensor([octree.shape[0]], dtype=torch.int32))
    return {
        "octree": octree,
        "empty": torch.from_numpy(empty).to(probs.device),
        "level": int(out_level),
        "pyramid": pyramid[0],
        "exsum": exsum,
        "probabilities": probs[final_keep],
        "colors": colors[final_keep],
        "normals": normals[final_keep],
    }


def process_frame(batch, level, sigma):
    """Carve one calibrated RGBD frame into a 3-state SPC. Ref :27. Runs on
    the device of the frame's depth map (the CPU for arrays)."""
    (image, depth_map, cam, intrinsics, max_depth, mip_levels, true_depth,
     start_level, points) = batch[:9]
    depth_map = torch.as_tensor(depth_map)
    device = depth_map.device
    image = torch.as_tensor(image).to(device, torch.float32)
    points_h = np.asarray(host(points), dtype=np.int32)

    depth_adj, mips = build_mip2d(depth_map, intrinsics, mip_levels,
                                  float(max_depth), bool(true_depth))

    states, occ_idx = _start_states(start_level)
    for l in range(start_level, level):
        occ, st = _oracle_b(torch.from_numpy(points_h).to(device), l, sigma,
                            cam, depth_adj, mips)
        occ, st = occ.cpu().numpy(), st.cpu().numpy()
        if occ.sum() == 0:
            raise BFReconstructionTerminatedException()
        states.append(st)
        points_h, oi = _child_points(points_h, occ)
        occ_idx.append(oi)

    pts = torch.from_numpy(points_h).to(device)
    occ, st, probs = _oracle_b_final(pts, level, sigma, cam, depth_adj)
    occ_h = occ.cpu().numpy()
    if occ_h.sum() == 0:
        raise BFReconstructionTerminatedException()
    states.append(st.cpu().numpy())

    kept = torch.from_numpy(np.nonzero(occ_h)[0]).to(device)
    probs_kept = probs[kept]
    colors_kept, normals_kept = _colors_b_final(
        pts[kept], level, cam, sigma, image, depth_adj, probs_kept)
    # expand back to the full final-level enumeration for _finalize masking
    n = pts.shape[0]
    probs_full = torch.zeros((n,), dtype=torch.float32, device=device)
    probs_full[kept] = probs_kept
    colors_full = torch.zeros((n, 4), dtype=torch.uint8, device=device)
    colors_full[kept] = colors_kept
    normals_full = torch.zeros((n, 3), dtype=torch.float32, device=device)
    normals_full[kept] = normals_kept

    return _finalize(states, occ_idx, level, probs_full, colors_full,
                     normals_full)


def _merge_level(points_h, level, spc0, spc1):
    """Both SPCs' walks at one level's points (host int32) → (occupancies,
    states, id0, id1) on the SPCs' device. Kernel d_MergeEmpty :532."""
    pts = torch.from_numpy(points_h).to(spc0["octree"].device)
    id0 = identify_empty(spc0["octree"], spc0["empty"], spc0["exsum"], pts,
                         level)
    id1 = identify_empty(spc1["octree"], spc1["empty"], spc1["exsum"], pts,
                         level)
    any_empty = (id0 == -1) | (id1 == -1)
    both_unseen = (id0 < -1) & (id1 < -1)
    occ = torch.where(any_empty | both_unseen, 0, 1).to(torch.int32)
    state = torch.where(any_empty, 0,
                        torch.where(both_unseen, 1, 2)).to(torch.int32)
    return occ, state, id0, id1


def _leaf_index(ids, offset, n):
    """Walk results → indices into a level's leaf arrays of length n."""
    return torch.clamp(ids.long() - offset, 0, max(0, n - 1))


def fuse_bf(spc0, spc1, start_level=4):
    """Fuse two 3-state SPCs with the closed-form Bayesian product. Ref :129
    (fuseBF) + kernels d_MergeEmpty :532, d_BQMerge :595."""
    level = spc0["level"]
    points_h = morton_to_points(torch.arange(8 ** start_level)).numpy() \
        .astype(np.int32)

    states, occ_idx = _start_states(start_level)
    for l in range(start_level, level):
        occ, st, _, _ = _merge_level(points_h, l, spc0, spc1)
        occ = occ.cpu().numpy()
        if occ.max(initial=0) == 0:
            raise BFReconstructionTerminatedException()
        states.append(st.cpu().numpy())
        points_h, oi = _child_points(points_h, occ)
        occ_idx.append(oi)

    occ, st, id0, id1 = _merge_level(points_h, level, spc0, spc1)
    if int(occ.max()) == 0:
        raise BFReconstructionTerminatedException()
    states.append(st.cpu().numpy())

    # bq_merge probability fusion + feature selection (kernel :595)
    off0 = int(spc0["pyramid"][1, level])
    off1 = int(spc1["pyramid"][1, level])
    prob0, prob1 = spc0["probabilities"], spc1["probabilities"]
    p0 = torch.where(id0 >= 0, prob0[_leaf_index(id0, off0, len(prob0))],
                     torch.where(id0 < -1, 0.5, 0.0)).to(torch.float32)
    p1 = torch.where(id1 >= 0, prob1[_leaf_index(id1, off1, len(prob1))],
                     torch.where(id1 < -1, 0.5, 0.0)).to(torch.float32)
    denom = p0 * p1 + (1.0 - p0) * (1.0 - p1)
    probs = torch.where(denom > 0,
                        p0 * p1 / torch.where(denom > 0, denom, 1.0), 0.0)
    use0 = (id0 >= 0)[:, None]
    i0 = _leaf_index(id0, off0, len(spc0["colors"]))
    i1 = _leaf_index(id1, off1, len(spc1["colors"]))
    colors = torch.where(use0, spc0["colors"][i0], spc1["colors"][i1])
    normals = torch.where(use0, spc0["normals"][i0], spc1["normals"][i1])
    probs = torch.where(st == 2, probs, 0.0).to(torch.float32)

    return _finalize(states, occ_idx, level, probs, colors.to(torch.uint8),
                     normals.to(torch.float32))


def extract_bq(spcd):
    """Extract the iso-surface voxels (probability 0.5 crossings of the dual
    grid) from a fused 3-state SPC. Ref :232 (extractBQ) + kernels
    d_BQTouch :818, d_BQExtract :739. The walk of the corners runs on the
    SPC's device, the descent on the host."""
    level = spcd["level"]
    octree_t = torch.as_tensor(spcd["octree"])
    device = octree_t.device
    octree = host(octree_t)
    empty = host(spcd["empty"])
    pyramid = host(spcd["pyramid"])
    probs_in = host(spcd["probabilities"])

    states = [np.full((1,), 2, dtype=np.int32)]
    occ_idx = [np.arange(1, dtype=np.int64)]
    points = morton_to_points(torch.arange(8)).numpy().astype(np.int32)

    # descent via bq_touch: states of the 8 children of each occupied node
    for l in range(1, level + 1):
        # bytes for nodes at level l-1 live at hierarchy positions of the
        # occupied level-(l-1) voxels; byte index == hierarchy index
        start = int(pyramid[1, l - 1])
        num = int(pyramid[0, l - 1])
        idx = np.arange(start, start + num)
        child_i = np.arange(8)
        o = (octree[idx][:, None] >> child_i[None]) & 1
        e = (empty[idx][:, None] >> child_i[None]) & 1
        st = np.where(o == 1, 2, np.where(e == 1, 1, 0)).astype(np.int32)
        st = st.reshape(-1)
        occ = (st == 2).astype(np.int32)
        if l < level:
            states.append(st)
            points, oi = _child_points(points, occ)
            occ_idx.append(oi)
        else:
            kept = np.nonzero(occ)[0]
            vox = points[kept]
            # bq_extract on occupied final voxels: dual-cell prob crossing
            n = vox.shape[0]
            corner_pts = (vox[:, None, :] + _CORNER_OFFS[None]).reshape(-1, 3)
            ids = host(identify_empty(
                octree_t, torch.as_tensor(spcd["empty"]),
                torch.as_tensor(spcd["exsum"]),
                torch.from_numpy(corner_pts).to(device),
                level)).reshape(n, 8)
            off = int(pyramid[1, level])
            pr = np.where(
                ids >= 0,
                probs_in[np.clip(ids - off, 0, max(0, len(probs_in) - 1))],
                np.where(ids == -1, 0.0, 0.5)).astype(np.float32)
            pmin = pr.min(axis=1)
            pmax = pr.max(axis=1)
            surf = (pmin < 0.5) & (0.5 < pmax)
            new_st = np.where(surf, 2,
                              np.where(pmax <= 0.5, 0, 1)).astype(np.int32)
            if not surf.any():
                raise BFReconstructionTerminatedException()
            full_st = st.copy()
            full_st[kept] = new_st
            states.append(full_st)
            surf_t = torch.from_numpy(surf).to(device)
            colors = torch.as_tensor(spcd["colors"])[surf_t]
            normals = torch.as_tensor(spcd["normals"])[surf_t]

    out_octree, out_empty = _assemble(states, occ_idx, level)
    return (torch.from_numpy(out_octree).to(device),
            torch.from_numpy(out_empty).to(device), colors, normals)


def bf_recon(input_dataset, final_level, sigma):
    """Reconstruct a 3-state SPC from calibrated RGBD views. Ref :321.

    Args:
        input_dataset: iterable of frame batches (see RayTracedSPCDataset);
            batch[9] is the any-ray-hit flag.
        final_level: octree depth.
        sigma: depth noise level.

    Returns:
        (octree uint8, empty uint8, colors (n,4) uint8, normals (n,3) f32)
        tensors on the frames' device, or (None, None, None, None) if
        fusion degenerates.
    """
    try:
        spc0 = None
        for batch in input_dataset:
            if not bool(batch[9]):
                continue
            frame = process_frame(batch, final_level, sigma)
            spc0 = frame if spc0 is None else fuse_bf(spc0, frame)
        if spc0 is None:
            return None, None, None, None
        return (spc0["octree"], spc0["empty"], spc0["colors"],
                spc0["normals"])
    except BFReconstructionTerminatedException:
        return None, None, None, None


# reference camelCase aliases (bf_recon.py:27,129,232)
processFrame = process_frame
fuseBF = fuse_bf
extractBQ = extract_bq

from kaolin_tpu_torch.ops.spc.exsum_compat import ensure_current_exsum  # noqa: F401,E402
