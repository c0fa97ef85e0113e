"""First-hit depth rendering of a Structured Point Cloud with
kaolin_tpu_torch: BASELINE config 3 (``bench.py:bench_raytrace``), a
level-9 sphere-shell SPC rendered at 512² through a pinhole camera.

``config3_inputs`` makes the scene's points with numpy, ``build_scene``
turns them into an octree, its point hierarchy, the raster payload and the
camera, ``grow_caps`` finds binning capacities that leave no overflow, and
``config3_frames`` renders a sequence of frames. ``main`` runs on the CUDA
device by default, through the hand-written raster kernels; on the CPU,
when ``"cpu"`` is named, through their plain PyTorch versions.

Run from the repository root:
    PYTHONPATH=. python examples/torch_spc_raster.py [cuda|cpu] [level] [res]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc import (
    generate_points,
    scan_octrees,
    unbatched_points_to_octree,
)
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.spc import (
    build_raster_spc,
    raster_first_hit,
    raster_first_hit_sequence,
)

# (tile_px, s_max, c_cap) the capacity growth starts from, as bench.py
START_CAPS = (16, 16, 64)
# renders before grow_caps gives up: s_max x4 per round reaches 16384
GROW_ROUNDS = 6


def config3_inputs(level=9, n=400_000):
    """Config 3 as numpy: ``n`` random directions from ``RandomState(0)``
    on two shells of radii 0.62 and 0.618 (watertight at level 9),
    quantized at ``level``; the camera at (1.6, 1.1, 1.6) looking at the
    origin with a vertical field of view of 0.8 rad."""
    rng = np.random.RandomState(0)
    grid = 2 ** level
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.concatenate([d * 0.62, d * 0.618])
    q = np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                          grid - 1), axis=0)
    return {"points": q.astype(np.int16), "level": level,
            "eye": np.array([1.6, 1.1, 1.6], np.float32),
            "at": np.zeros(3, np.float32),
            "up": np.array([0.0, 1.0, 0.0], np.float32), "fov": 0.8}


def build_scene(inputs, device, res):
    """Octree, point hierarchy, raster payload and camera of a scene, on
    ``device`` → (rspc, camera, spc) with spc holding ``octree``,
    ``point_hierarchy``, ``pyramid`` and ``exsum``."""
    level = inputs["level"]
    octree = unbatched_points_to_octree(inputs["points"], level,
                                        device=device)
    _, pyramids, exsum = scan_octrees(octree, torch.tensor([len(octree)]))
    point_hierarchy = generate_points(octree, pyramids, exsum)
    rspc = build_raster_spc(point_hierarchy, pyramids[0], level)
    camera = Camera.from_args(
        eye=torch.from_numpy(inputs["eye"]), at=torch.from_numpy(inputs["at"]),
        up=torch.from_numpy(inputs["up"]), fov=inputs["fov"], width=res,
        height=res, device=device)
    return rspc, camera, {"octree": octree, "point_hierarchy": point_hierarchy,
                          "pyramid": pyramids[0], "exsum": exsum}


def grow_caps(rspc, camera, caps=START_CAPS):
    """Render, and grow ``s_max`` ×4 on a slot overflow and ``c_cap`` ×2 on
    a capacity overflow until neither is left, as ``bench.py`` does →
    ((tile_px, s_max, c_cap), the last render). Raises RuntimeError when
    ``GROW_ROUNDS`` renders leave an overflow."""
    tile_px, s_max, c_cap = caps
    for _ in range(GROW_ROUNDS):
        out = raster_first_hit(rspc, camera, tile_px=tile_px, s_max=s_max,
                               c_cap=c_cap)
        slot_ov = int(out[3]["slot_overflow"])
        cap_ov = int(out[3]["cap_overflow"])
        if slot_ov == 0 and cap_ov == 0:
            return (tile_px, s_max, c_cap), out
        if slot_ov:
            s_max *= 4
        if cap_ov:
            c_cap *= 2
    raise RuntimeError(f"binning still overflows after {GROW_ROUNDS} renders "
                       f"(slot {slot_ov}, cap {cap_ov}; s_max {s_max}, "
                       f"c_cap {c_cap})")


def config3_frames(device, res=512, frames=60, level=9):
    """Build config 3, grow its capacities, and render ``frames`` frames of
    its camera as one sequence → dict with ``depth``, ``nidx`` and
    ``valid`` (F, H·W), the summed ``overflow``, the ``caps``, the
    ``rspc`` and the ``camera``."""
    rspc, camera, _ = build_scene(config3_inputs(level), device, res)
    caps, _ = grow_caps(rspc, camera)
    tile_px, s_max, c_cap = caps
    depth, nidx, valid, overflow = raster_first_hit_sequence(
        rspc, [camera] * frames, tile_px=tile_px, s_max=s_max, c_cap=c_cap)
    return {"depth": depth, "nidx": nidx, "valid": valid,
            "overflow": {k: int(v) for k, v in overflow.items()},
            "caps": caps, "rspc": rspc, "camera": camera}


def main(device="cuda", level=9, res=512):
    """Render one depth image of config 3 on ``device`` (the CUDA device
    unless ``"cpu"`` is named) → (depth (res, res), caps)."""
    rspc, camera, _ = build_scene(config3_inputs(level), device, res)
    caps, (t, nidx, valid, _) = grow_caps(rspc, camera)
    depth = t.reshape(res, res)
    hits = depth[torch.isfinite(depth)]
    print(f"level {level}, {rspc.units.shape[0]} units of 128 leaves, "
          f"{res}x{res}, caps (tile_px, s_max, c_cap) {caps}: "
          f"{int(valid.sum())} pixels hit, depth "
          f"{float(hits.min()):.4f}..{float(hits.max()):.4f}")
    return depth, caps


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda",
         *(int(a) for a in sys.argv[2:4]))
