"""The plain reference of the DIB-R pose-and-texture fit, in PyTorch.

Frozen copies of the port's plain paths, so that the comparison that
decides ``correct`` reads the same whatever later changes make of the
port: the quaternion and camera maths, ``prepare_vertices``, the brute
winner search, the differentiable re-gather at the winners, the all-faces
soft silhouette with the backward rule of the port's kernel (the cotangent
into each in-box face's d² is ``ga·k·p / (1 − p)``), bilinear
``texture_mapping``, ``mask_iou``, the dense uniform Laplacian and Adam.
It imports nothing of the port and takes nothing the port made: from the
benchmark's inputs it works out the cameras, the projection, the
Laplacian, the target renders and the fit's state again.

The searches walk the (pixel, face) pairs with the pixel centre in the
face's box, at most ``limit`` at a time, in every view at once: the
winner by a scatter of the largest depth and then of the lowest id among
the pixel's closest faces, the soft mask by a scatter of the product of
its factors, its gradient by a scatter-add into each face. The scatters'
order, and so the soft mask's rounding, is not fixed.
"""

import math

import torch

EPS_BARY = 1e-8
EPS_DIST = 1e-10
EPS_QUAT = 1e-12
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# -- quaternions, pose ------------------------------------------------------
def quat_unit(q):
    return q / torch.maximum(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                             q.new_tensor(EPS_QUAT))


def quat_from_angle_axis(angle, axis):
    """(angle (..., 1) radians, axis (..., 3)) → (x, y, z, w)."""
    half = 0.5 * angle
    n = torch.maximum(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                      axis.new_tensor(EPS_QUAT))
    return torch.cat([torch.sin(half) * (axis / n), torch.cos(half)], dim=-1)


def rot33_from_quat(q):
    x, y, z, w = torch.unbind(q, -1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def posed_vertices(template, params):
    """v = R(unit q)·(exp(s)·(template + offsets)) + t → (V, 3)."""
    rot = rot33_from_quat(quat_unit(params["q"]))
    shape = template if "offsets" not in params \
        else template + params["offsets"]
    return (torch.exp(params["s"]) * shape) @ rot.T + params["t"]


# -- cameras ----------------------------------------------------------------
def _unit_rows(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def look_at_matrices(cam_pos, look_at, up):
    """(N, 4, 3) M with P_cam = [P_world, 1] @ M."""
    z = _unit_rows(cam_pos - look_at)
    x = _unit_rows(torch.linalg.cross(up.expand_as(z), z))
    y = torch.linalg.cross(z, x)
    rot = torch.stack([x, y, z], dim=2)
    return torch.cat([rot, torch.matmul(-cam_pos[:, None, :], rot)], dim=1)


def projection(fovy, dtype, device):
    """The (3, 1) projection vector of a vertical field of view (radians)."""
    t = math.tan(fovy / 2.0)
    return torch.tensor([[1.0 / t], [1.0 / t], [-1.0]], dtype=dtype,
                        device=device)


def prepare_vertices(vertices, faces, proj, cams):
    """vertices (1, V, 3), cams (B, 4, 3) → (face z (B, F, 3), face image
    coordinates (B, F, 3, 2), face normal z (B, F))."""
    cam = torch.cat([vertices, torch.ones_like(vertices[..., :1])],
                    dim=-1) @ cams
    p = cam * proj.reshape(-1, 1, 3)
    img = p[:, :, :2] / p[:, :, 2:3]
    fc = cam[:, faces]
    n = torch.linalg.cross(fc[:, :, 1] - fc[:, :, 0], fc[:, :, 2] - fc[:, :, 0])
    n = n / (torch.linalg.vector_norm(n, dim=2, keepdim=True) + EPS_DIST)
    return fc[..., 2], img[:, faces], n[..., 2]


def uniform_laplacian(num_vertices, faces):
    """Dense (V, V): 1/deg(i) at i's neighbours, −1 on the diagonal."""
    f = faces.long()
    a = torch.stack([f, f.roll(1, dims=1)], -1).reshape(-1, 2)
    adj = torch.zeros((num_vertices, num_vertices), dtype=torch.float32,
                      device=faces.device)
    adj[a[:, 0], a[:, 1]] = 1.0
    adj[a[:, 1], a[:, 0]] = 1.0
    deg = adj.sum(dim=1, keepdim=True)
    lap = torch.where(deg > 0, adj / deg, 0.0)
    lap.fill_diagonal_(-1.0)
    return lap


# -- rasterization ----------------------------------------------------------
def pixel_coords(height, width, multiplier, dtype, device):
    """Pixel-centre coordinates, x right and y up → (px, py), each (H, W)."""
    wid = torch.arange(width, dtype=dtype, device=device)
    hei = torch.arange(height, dtype=dtype, device=device)
    x0 = multiplier / width * (2 * wid + 1 - width)
    y0 = multiplier / height * (height - 2 * hei - 1)
    return torch.meshgrid(x0, y0, indexing="xy")


def barycentrics(px, py, verts, eps=EPS_BARY):
    ax = verts[..., 0, 0] - px
    ay = verts[..., 0, 1] - py
    bx = verts[..., 1, 0] - px
    by = verts[..., 1, 1] - py
    cx = verts[..., 2, 0] - px
    cy = verts[..., 2, 1] - py
    w0 = bx * cy - by * cx
    w1 = cx * ay - cy * ax
    w2 = ax * by - ay * bx
    norm = w0 + w1 + w2
    norm = norm + torch.where(norm >= 0, eps, -eps)
    return w0 / norm, w1 / norm, w2 / norm


def box_ranges(verts, margin, closed, height, width, multiplier):
    """The pixel centres in each face's box, enlarged by ``margin``, closed
    or half open at the top: rows [r0, r0 + nr) and columns [c0, c0 + nc)
    of faces ``verts`` (N, 3, 2), scaled by ``multiplier`` → (r0, nr, c0,
    nc), each (N,) int64. The centres are compared as the kernels compare
    them, in float32."""
    px, py = pixel_coords(height, width, multiplier, verts.dtype,
                          verts.device)
    xs, ys = px[0].contiguous(), py[:, 0].flip(0).contiguous()  # ascending
    lo = verts.amin(dim=1) - margin
    hi = verts.amax(dim=1) + margin
    side = "right" if closed else "left"

    def span(coords, a, b):
        first = torch.searchsorted(coords, a.contiguous(), side="left")
        last = torch.searchsorted(coords, b.contiguous(), side=side)
        return first, torch.clamp(last - first, min=0)

    c0, nc = span(xs, lo[:, 0], hi[:, 0])
    j0, nr = span(ys, lo[:, 1], hi[:, 1])
    return height - j0 - nr, nr, c0, nc       # row r holds ys[H - 1 - r]


def pairs(ranges, limit):
    """The (face, row, column) pairs of ``box_ranges``, at most ``limit``
    a chunk → yields (face ids, rows, columns), each (P,) int64."""
    r0, nr, c0, nc = ranges
    n = nr * nc
    ends = torch.cumsum(n, 0)
    total = int(ends[-1]) if n.numel() else 0
    marks = torch.tensor(range(limit, total, limit), dtype=ends.dtype,
                         device=n.device)
    cuts = torch.searchsorted(ends, marks, side="right").tolist()
    for a, b in zip([0] + cuts, cuts + [n.numel()]):
        if b <= a:
            continue
        ids = torch.arange(a, b, device=n.device)
        m = n[a:b]
        face = torch.repeat_interleave(ids, m)
        if face.numel() == 0:
            continue
        j = torch.arange(face.numel(), device=n.device) \
            - torch.repeat_interleave(torch.cumsum(m, 0) - m, m)
        width = nc[face]
        yield face, r0[face] + j // width, c0[face] + j % width


def winner_search(fvz, fvi, valid, height, width, multiplier, limit):
    """Brute winner search → (B, H, W) int32 face ids, −1 on a miss: of the
    valid faces whose closed box holds the pixel centre and whose
    barycentrics are all ≥ 0, the closest (largest z); ties to the lowest
    id. ``fvi`` is scaled by ``multiplier``; at most ``limit`` (pixel,
    face) pairs at a time."""
    b, f = fvz.shape[:2]
    px, py = pixel_coords(height, width, multiplier, fvz.dtype, fvz.device)
    verts, zs = fvi.reshape(b * f, 3, 2), fvz.reshape(b * f, 3)
    r0, nr, c0, nc = box_ranges(verts, 0.0, True, height, width, multiplier)
    ranges = (r0, torch.where(valid.reshape(-1), nr, 0), c0, nc)
    best = torch.full((b * height * width,), -torch.inf, dtype=fvz.dtype,
                      device=fvz.device)
    hits = []
    for face, row, col in pairs(ranges, limit):
        v = verts[face]
        w0, w1, w2 = barycentrics(px[0, col], py[row, 0], v)
        z = w0 * zs[face, 0] + w1 * zs[face, 1] + w2 * zs[face, 2]
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        pix = (face // f) * height * width + row * width + col
        pix, z, face = pix[inside], z[inside], face[inside]
        best.scatter_reduce_(0, pix, z, "amax")
        hits.append((pix, z, face % f))
    ids = torch.full((b * height * width,), f, dtype=torch.int64,
                     device=fvz.device)
    for pix, z, face in hits:
        top = z == best[pix]
        ids.scatter_reduce_(0, pix[top], face[top], "amin")
    ids = torch.where(torch.isfinite(best), ids, -1)
    return ids.to(torch.int32).reshape(b, height, width)


def interpolate(face_idx, scaled, features, multiplier):
    """The winners' barycentric interpolation of ``features`` (B, F, 3, D)
    → (B, H, W, D), 0 on a miss; differentiable in ``scaled`` and
    ``features``."""
    b, height, width = face_idx.shape
    f, d = scaled.shape[1], features.shape[-1]
    table = torch.cat([scaled.reshape(b, f, 6),
                       features.reshape(b, f, 3 * d)], dim=-1)
    idx = face_idx.clamp(min=0).long().reshape(b, -1, 1)
    sel = torch.gather(table, 1, idx.expand(-1, -1, table.shape[-1]))
    sel_v = sel[..., :6].reshape(b, height, width, 3, 2)
    sel_f = sel[..., 6:].reshape(b, height, width, 3, d)
    px, py = pixel_coords(height, width, multiplier, scaled.dtype,
                          scaled.device)
    w0, w1, w2 = barycentrics(px[None], py[None], sel_v)
    out = (w0[..., None] * sel_f[..., 0, :] + w1[..., None] * sel_f[..., 1, :]
           + w2[..., None] * sel_f[..., 2, :])
    return torch.where((face_idx >= 0)[..., None], out, 0.0)


def sqdist(px, py, verts, multiplier):
    """Least squared distance from each pixel centre (P,) to its face's
    (P, 3, 2) 3 edges (where the foot lies on the segment) and 3 vertices
    → (P,). Tied minima share the gradient evenly (``torch.amin``)."""
    d = []
    for i in range(3):
        x1, y1 = verts[:, i, 0], verts[:, i, 1]
        x2, y2 = verts[:, (i + 1) % 3, 0], verts[:, (i + 1) % 3, 1]
        a = y2 - y1
        bb = x1 - x2
        c = x2 * y1 - x1 * y2
        up = a * px + bb * py + c
        down = a * a + bb * bb
        x3 = (bb * bb * px - a * bb * py - a * c) / (down + EPS_DIST)
        y3 = (a * a * py - a * bb * px - bb * c) / (down + EPS_DIST)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        d.append(torch.where(direct > 0, 4.0 * multiplier * multiplier,
                             up * up / (down + EPS_DIST)))
    for i in range(3):
        d.append((px - verts[:, i, 0]) ** 2 + (py - verts[:, i, 1]) ** 2)
    return torch.amin(torch.stack(d, dim=-1), dim=-1)


def _soft_pairs(fvi, need, boxlen, multiplier, limit):
    """The (pixel, face) pairs with the pixel centre in the face's
    enlarged, half-open box, where ``need`` (B, H, W) holds → yields (face
    ids into (B·F), flat pixel ids into (B·H·W), px, py), each (P,)."""
    b, f = fvi.shape[:2]
    height, width = need.shape[1:]
    px, py = pixel_coords(height, width, multiplier, fvi.dtype, fvi.device)
    verts = fvi.reshape(b * f, 3, 2)
    ranges = box_ranges(verts, boxlen * multiplier, False, height, width,
                        multiplier)
    flat = need.reshape(-1)
    for face, row, col in pairs(ranges, limit):
        pix = (face // f) * height * width + row * width + col
        keep = flat[pix]
        yield face[keep], pix[keep], px[0, col[keep]], py[row[keep], 0]


def _prob(d2, sigmainv, multiplier):
    return torch.exp(-sigmainv * d2 / (multiplier * multiplier))


def soft_allprob(fvi, face_idx, sigmainv, boxlen, multiplier, limit):
    """∏ (1 − exp(−k·d²)) over the in-box faces at the pixels the
    rasterizer leaves uncovered, 1 at covered pixels → (B, H, W)."""
    verts = fvi.reshape(-1, 3, 2)
    allprob = torch.ones(face_idx.numel(), dtype=fvi.dtype,
                         device=fvi.device)
    for face, pix, x, y in _soft_pairs(fvi, face_idx < 0, boxlen, multiplier,
                                       limit):
        p = _prob(sqdist(x, y, verts[face], multiplier), sigmainv,
                  multiplier)
        allprob.scatter_reduce_(0, pix, 1.0 - p, "prod")
    return torch.where(face_idx >= 0, 1.0, allprob.reshape(face_idx.shape))


def soft_allprob_vjp(fvi, ga, sigmainv, boxlen, multiplier, limit):
    """The gradient into ``fvi`` (B, F, 3, 2) given ``ga = grad·allprob``:
    each in-box face's d² gets ``ga·k·p / max(1 − p, 1e-12)``, pushed
    through d² by autograd."""
    k = sigmainv / (multiplier * multiplier)
    verts = fvi.detach().reshape(-1, 3, 2)
    g = ga.reshape(-1)
    grad = torch.zeros_like(verts)
    with torch.enable_grad():
        for face, pix, x, y in _soft_pairs(fvi, ga != 0, boxlen, multiplier,
                                           limit):
            v = verts[face].requires_grad_(True)
            d2 = sqdist(x, y, v, multiplier)
            p = _prob(d2, sigmainv, multiplier).detach()
            c = g[pix] / torch.clamp(1.0 - p, min=1e-12) * k * p
            grad.index_add_(0, face, torch.autograd.grad(d2, v, c)[0])
    return grad.reshape(fvi.shape)


class SoftMask(torch.autograd.Function):
    """allprob of the scaled faces, with the port kernel's backward rule."""

    @staticmethod
    def forward(ctx, fvi, face_idx, sigmainv, boxlen, multiplier, limit):
        allprob = soft_allprob(fvi.detach(), face_idx, sigmainv, boxlen,
                               multiplier, limit)
        ctx.save_for_backward(fvi.detach(), allprob)
        ctx.args = (sigmainv, boxlen, multiplier, limit)
        return allprob

    @staticmethod
    def backward(ctx, grad):
        fvi, allprob = ctx.saved_tensors
        return (soft_allprob_vjp(fvi, grad * allprob, *ctx.args),
                None, None, None, None, None)


def dibr_rasterization(height, width, fvz, fvi, features, normals_z,
                       sigmainv, boxlen, multiplier, limit, soft=True):
    """(features at the winners (B, H, W, D), soft mask (B, H, W) or None
    without ``soft``, face_idx (B, H, W)); faces with normal z ≥ 0 are
    kept."""
    scaled = fvi * multiplier
    valid = normals_z >= 0.0
    with torch.no_grad():
        face_idx = winner_search(fvz.detach(), scaled.detach(), valid, height,
                                 width, multiplier, limit)
    image = interpolate(face_idx, scaled, features, multiplier)
    if not soft:
        return image, None, face_idx
    allprob = SoftMask.apply(scaled, face_idx, sigmainv, boxlen, multiplier,
                             limit)
    return image, torch.where(face_idx >= 0, 1.0, 1.0 - allprob), face_idx


# -- texture, loss, optimiser ------------------------------------------------
def texture_mapping(uv, texture):
    """Bilinear sampling of ``texture`` (B, C, h, w) at OpenGL UVs (B, H,
    W, 2), border padding, align_corners False; the UV clip splits its
    gradient at 0 and 1 → (B, H, W, C)."""
    b, c, h, w = texture.shape
    tc = uv.reshape(b, -1, 2)
    tc = torch.minimum(torch.maximum(tc, tc.new_tensor(0.0)),
                       tc.new_tensor(1.0)) * 2.0 - 1.0
    tc = tc * tc.new_tensor([1.0, -1.0])
    x = (tc[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (tc[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[:, None], (y - y0)[:, None]
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
    x1i = torch.clamp(x0.to(torch.int32) + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0.to(torch.int32) + 1, 0, h - 1)
    flat = texture.reshape(b, c, h * w)

    def gather(yi, xi):
        idx = (yi.long() * w + xi.long())[:, None, :]
        return torch.gather(flat, 2, idx.expand(-1, c, -1))

    out = (gather(y0i, x0i) * (1 - tx) * (1 - ty)
           + gather(y0i, x1i) * tx * (1 - ty)
           + gather(y1i, x0i) * (1 - tx) * ty + gather(y1i, x1i) * tx * ty)
    return out.transpose(1, 2).reshape(*uv.shape[:-1], c)


def mask_iou(lhs, rhs):
    b = lhs.shape[0]
    mul = lhs * rhs
    up = torch.sum(mul.reshape(b, -1), dim=1)
    down = torch.sum((lhs + rhs - mul).reshape(b, -1), dim=1)
    return 1.0 - torch.mean(up / (down + 1e-10))


def adam_step(params, state, lr, t):
    """One Adam step of torch.optim.Adam's defaults, in place."""
    b1, b2 = BETAS
    with torch.no_grad():
        for name, p in params.items():
            g = p.grad
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
