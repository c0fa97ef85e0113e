"""Tutorial: understanding Structured Point Clouds (SPCs), with
kaolin_tpu_torch.

The counterpart of ``examples/tutorial_understanding_spcs.py``: quantize a
point cloud into an octree, scan it into the (pyramid, exsum) acceleration
structure, inspect the level hierarchy, query points against it, convert
to a dense grid, and raytrace a depth image. It runs on the CUDA device
unless ``cpu`` is named; ``smoke`` runs the small sizes:

    PYTHONPATH=. python examples/torch_tutorial_understanding_spcs.py \
        [cuda|cpu] [smoke]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc import (
    generate_points,
    morton_to_points,
    points_to_morton,
    quantize_points,
    scan_octrees,
    to_dense,
    unbatched_get_level_points,
    unbatched_points_to_octree,
    unbatched_query,
)
from kaolin_tpu_torch.render.camera import Camera, generate_rays
from kaolin_tpu_torch.render.spc import unbatched_raytrace


def main(device="cuda", smoke=False):
    """Each step of the tutorial on ``device``, asserting what the JAX
    tutorial asserts → dict with the octree, the dense grid and the depth
    image."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; name 'cpu' to run on the CPU")
    level = 4 if smoke else 6
    res_img = 32 if smoke else 128
    rng = np.random.RandomState(0)

    # 1. a point cloud on a sphere surface, in the SPC's [-1, 1]^3 domain
    n = 2000 if smoke else 50_000
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cloud = torch.from_numpy(d * 0.7).to(device)

    # 2. quantize to integer cells at `level` and build the octree bytes
    q = quantize_points(cloud, level)                      # (N, 3) int16
    octree = unbatched_points_to_octree(q, level)          # (num_bytes,) u8
    print(f"octree: {octree.shape[0]} bytes at level {level}")

    # 3. scan: per-level pyramid + exclusive-sum child offsets
    lengths = torch.tensor([octree.shape[0]], dtype=torch.int32)
    max_level, pyramids, exsum = scan_octrees(octree, lengths)
    pyramid = pyramids[0].cpu().numpy()
    for lv in range(max_level + 1):
        print(f"  level {lv}: {pyramid[0, lv]} nodes "
              f"(offset {pyramid[1, lv]})")

    # 4. the point hierarchy: every node's integer coords, all levels
    point_hierarchy = generate_points(octree, pyramids, exsum)
    leaves = unbatched_get_level_points(point_hierarchy, pyramid, level)
    print(f"leaf points: {tuple(leaves.shape)}")
    assert leaves.shape[0] == pyramid[0, level]

    # Morton codes round-trip (the SPC ordering invariant)
    mort = points_to_morton(leaves)
    assert bool(torch.all(morton_to_points(mort) == leaves))
    assert bool(torch.all(torch.diff(mort) > 0)), "SPC points are morton-sorted"

    # 5. query: where does an arbitrary coordinate land in the octree?
    probe_pts = torch.from_numpy(
        rng.uniform(-1, 1, (64, 3)).astype(np.float32)).to(device)
    pidx = unbatched_query(octree, exsum, probe_pts, level)
    inside = int((pidx >= 0).sum())
    print(f"query: {inside}/64 random points landed in occupied leaves")

    # surface points must query back to themselves
    self_idx = unbatched_query(octree, exsum,
                               (leaves.to(torch.float32) + 0.5)
                               * (2.0 / 2 ** level) - 1.0, level)
    assert bool(torch.all(self_idx >= 0))

    # 6. dense conversion: one-hot occupancy grid from leaf features
    feats = torch.ones((int(pyramid[0, level]), 1), device=device)
    dense = to_dense(point_hierarchy, pyramids, feats, level)
    print(f"dense grid: {tuple(dense.shape)}, occupied {int(dense.sum())}")
    assert int(dense.sum()) == int(pyramid[0, level])

    # 7. raytrace a depth image (nuggets = depth-sorted ray/leaf hits)
    camera = Camera.from_args(eye=torch.tensor([1.8, 1.2, 1.8]),
                              at=torch.zeros(3),
                              up=torch.tensor([0.0, 1.0, 0.0]),
                              fov=0.9, width=res_img, height=res_img,
                              device=device)
    origins, dirs = generate_rays(camera)
    ridx, pidx, depth = unbatched_raytrace(
        octree, point_hierarchy, pyramid, exsum, origins, dirs, level)
    img = torch.full((res_img * res_img,), float("inf"), device=device)
    img = img.scatter_reduce(0, ridx.long(), depth[:, 0], "amin")
    hit_px = int(torch.isfinite(img).sum())
    print(f"raytrace: {ridx.shape[0]} nuggets, {hit_px} hit pixels")
    assert hit_px > res_img * res_img * 0.05
    print("done")
    return {"octree": octree, "dense": dense,
            "depth": img.reshape(res_img, res_img)}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda",
         smoke="smoke" in sys.argv[2:])
