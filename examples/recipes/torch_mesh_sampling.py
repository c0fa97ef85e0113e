"""Preprocess recipes in the port: area-weighted surface sampling and
occupancy (inside/outside) sampling.

Counterpart of ``examples/recipes/mesh_sampling.py``, line for line; on the
card unless ``cpu`` is named. JAX's jitted sampler of a key is a plain
function of a ``torch.Generator``: a CPU generator seeded 0, whose draws
go to the device, so that every device prints the same samples.

Run: PYTHONPATH=. python examples/recipes/torch_mesh_sampling.py [cuda|cpu]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.mesh import check_sign, sample_points
from kaolin_tpu_torch.utils.backend import resolve_device


def main(device=None):
    device = resolve_device(device, "the mesh sampling recipe")
    # a unit cube mesh
    v = torch.tensor([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0)
                      for z in (0.0, 1.0)], dtype=torch.float32,
                     device=device)
    f = torch.tensor([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                     device=device)

    # -- fast_mesh_sampling.py: area-weighted surface samples --
    def sample(generator):
        pts, face_choices = sample_points(v[None], f, 2048,
                                          generator=generator)
        return pts, face_choices

    pts, choices = sample(torch.Generator().manual_seed(0))
    print("surface samples:", tuple(pts.shape), "| per-face histogram head:",
          np.bincount(choices.cpu().numpy().ravel(), minlength=12)[:6])

    # -- occupancy_sampling.py: inside/outside test for volume points --
    query = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.2, 1.2, (1, 4096, 3)).astype(np.float32)).to(device)
    inside = check_sign(v[None], f, query)
    frac = float(torch.mean(inside.to(torch.float32)))
    print(f"occupancy fraction: {frac:.3f} (expected ~ "
          f"{1.0 / (1.4 ** 3):.3f})")
    return {"pts": pts, "choices": choices, "inside": inside}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
