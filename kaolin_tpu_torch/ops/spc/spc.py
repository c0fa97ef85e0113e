"""SPC core: octree scanning and point generation.

Counterpart of ``kaolin_tpu/ops/spc/spc.py``. Layout: byte-packed
Morton-BFS octrees, pyramids (B, 2, max_level + 2) with per-level counts
and offsets, exsum the per-octree inclusive popcount sum. Both run on the
host in numpy, as in the JAX package (variable-length outputs, once per
asset), and return tensors on the octree's device.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import device_of, host

__all__ = ["scan_octrees", "generate_points", "unbatched_get_level_points"]

_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)],
                           dtype=np.int32)


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


def scan_octrees(octrees, lengths, legacy_exsum=False):
    """(packed uint8 octrees, lengths (B,)) → (max_level, pyramids
    (B, 2, max_level + 2) int32, exsum int32)."""
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
    device = device_of(octrees, None)
    return (max_level, torch.from_numpy(pyramids).to(device),
            torch.from_numpy(np.concatenate(exsums).astype(np.int32)).to(
                device))


def generate_points(octrees, pyramids, exsum):
    """Decode octrees → packed point hierarchies (num_points, 3) int16."""
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
            device_of(octrees, None))


def unbatched_get_level_points(point_hierarchy, pyramid, level):
    """The points of one level of one octree."""
    pyramid = host(pyramid)
    start = int(pyramid[1, level])
    return point_hierarchy[start:start + int(pyramid[0, level])]
