"""Point-cloud ops: centering and farthest-point sampling, in PyTorch.

Counterpart of ``kaolin_tpu/ops/pointcloud.py``. Farthest-point sampling is
k sequential passes over the N points: each updates the running least
squared distance to the points taken so far and takes its argmax. The
passes read nothing back to the host, so a cloud on the card is sampled
without a synchronization until its indices are read.
"""

import torch

__all__ = ["center_points", "farthest_point_sampling"]

# least distances of the points that are never taken first: rows with an
# inf or NaN coordinate, then the points already taken
_INVALID_DIST = -1.0
_TAKEN_DIST = -2.0


def center_points(points, normalize=False, eps=1e-6):
    """Centre each cloud at the origin; with ``normalize`` also scale its
    largest box side to 1. (B, N, C) → the same shape."""
    if points.ndim != 3:
        raise ValueError(f"unexpected shape {tuple(points.shape)}")
    vmin = points.amin(dim=1, keepdim=True)
    vmax = points.amax(dim=1, keepdim=True)
    res = points - (vmin + vmax) / 2
    if normalize:
        den = torch.clamp((vmax - vmin).amax(dim=-1, keepdim=True), min=eps)
        res = res / den
    return res


def _squared_distances(pts, p):
    """|pts − p|² as three products and two sums in a fixed order, so that
    the card and the CPU round alike: (N, 3), (3,) → (N,)."""
    d = pts - p
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def _fps_unbatched(points, k, out):
    finite = torch.isfinite(points).all(dim=-1)
    safe = torch.where(finite[:, None], points, torch.zeros_like(points))
    # the first point: the farthest from the mean of the cloud (inf and NaN
    # rows count as the origin in the mean)
    d0 = _squared_distances(safe, safe.mean(dim=0))
    d0 = torch.where(finite, d0, torch.full_like(d0, _INVALID_DIST))
    last = torch.argmax(d0)
    min_dist = torch.full_like(d0, float("inf"))
    invalid = torch.full_like(d0, _INVALID_DIST)
    for i in range(k):
        out[i] = last
        if i == k - 1:
            break
        row = last.reshape(1)
        d = torch.where(finite, _squared_distances(
            safe, safe.index_select(0, row)[0]), invalid)
        min_dist = torch.minimum(min_dist, d)
        min_dist.index_fill_(0, row, _TAKEN_DIST)
        last = torch.argmax(min_dist)
    return out


def farthest_point_sampling(points, k):
    """Blue-noise subset selection: (B, N, 3) → indices (B, k) int32 on the
    points' device.

    The first point is the one farthest from the cloud's mean; each next
    one is the farthest from those taken. Rows with an inf or NaN
    coordinate come after every finite point, so k distinct indices come
    back for any k ≤ N. Ties go to the lowest index."""
    if points.ndim != 3:
        raise ValueError(f"unexpected shape {tuple(points.shape)}")
    b, n = points.shape[:2]
    if not 0 < k <= n:
        raise ValueError(f"k = {k} must be in [1, {n}]")
    out = torch.empty((b, k), dtype=torch.int64, device=points.device)
    for i in range(b):
        _fps_unbatched(points[i], int(k), out[i])
    return out.to(torch.int32)
