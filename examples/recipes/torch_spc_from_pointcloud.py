"""Dataload recipe in the port: pointcloud -> SPC with averaged per-cell
features.

Counterpart of ``examples/recipes/spc_from_pointcloud.py``, line for line;
on the card unless ``cpu`` is named.

Run: PYTHONPATH=. python examples/recipes/torch_spc_from_pointcloud.py
     [cuda|cpu]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
from kaolin_tpu_torch.utils.backend import resolve_device


def main(device=None):
    device = resolve_device(device, "the SPC-from-pointcloud recipe")
    rng = np.random.RandomState(0)
    cloud = torch.from_numpy(
        rng.uniform(-1, 1, (10000, 3)).astype(np.float32)).to(device)
    colors = torch.from_numpy(rng.rand(10000, 3).astype(np.float32)).to(
        device)

    spc = unbatched_pointcloud_to_spc(cloud, level=5, features=colors)
    print("octree bytes:", int(spc.octrees.shape[0]),
          "| leaf cells:", int(spc.num_points(5).reshape(-1)[0]),
          "| features:", None if spc.features is None
          else tuple(spc.features.shape))
    return {"spc": spc}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
