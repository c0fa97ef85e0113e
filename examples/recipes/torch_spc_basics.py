"""SPC recipes in the port: octree construction, query, dual octree,
trilinear interpolation, sparse conv.

Counterpart of ``examples/recipes/spc_basics.py``, line for line; on the
card unless ``cpu`` is named. The sparse ``Conv3d`` is the port's module,
its weights drawn from a CPU generator seeded 0, or ``conv_weight`` (K,
Cin, Cout) where given (the tests carry JAX's ``conv.init`` across).

Run: PYTHONPATH=. python examples/recipes/torch_spc_basics.py [cuda|cpu]
"""

import sys

import numpy as np
import torch

import kaolin_tpu_torch.ops.spc as spc_ops
from kaolin_tpu_torch.utils.backend import resolve_device


def main(device=None, conv_weight=None):
    device = resolve_device(device, "the SPC recipe")

    # -- build an octree from quantized points (spc_basics.py) --
    level = 3
    pts = torch.from_numpy(np.random.RandomState(0).randint(
        0, 2 ** level, (40, 3)).astype(np.int16)).to(device)
    octree = spc_ops.unbatched_points_to_octree(pts, level)
    lengths = torch.tensor([len(octree)], dtype=torch.int32, device=device)
    max_level, pyramids, exsum = spc_ops.scan_octrees(octree, lengths)
    point_hierarchy = spc_ops.generate_points(octree, pyramids, exsum)
    print(f"octree: {len(octree)} bytes, levels={max_level}, "
          f"points per level="
          f"{pyramids.cpu().numpy()[0][0][:max_level + 1]}")

    # -- query cells containing coordinates (spc_basics.py) --
    res = 2 ** level
    inside = (pts[0].cpu().numpy() + 0.5) / res * 2.0 - 1.0  # a cell centre
    query = torch.tensor(np.asarray([inside, [0.999, 0.999, 0.999]]),
                         dtype=torch.float32, device=device)
    pidx = spc_ops.unbatched_query(octree, exsum, query, level)
    print("query results (−1 = empty space):", pidx.cpu().numpy())

    # -- dual octree: corners instead of cells (spc_dual_octree.py) --
    dual, pyr_dual = spc_ops.unbatched_make_dual(point_hierarchy,
                                                 pyramids[0])
    trinkets, parents = spc_ops.unbatched_make_trinkets(
        point_hierarchy, pyramids[0], dual, pyr_dual)
    print(f"dual octree: {dual.shape[0]} corners, trinkets "
          f"{tuple(trinkets.shape)}")

    # -- trilinear interpolation of corner features
    #    (spc_trilinear_interp.py) --
    feats = dual[:, :1].to(torch.float32)              # f = x coord
    coords = torch.tensor(np.asarray([[inside]]), dtype=torch.float32,
                          device=device)
    pidx2 = spc_ops.unbatched_query(octree, exsum, coords[:, 0], level)
    interp = spc_ops.unbatched_interpolate_trilinear(
        coords, pidx2, point_hierarchy, trinkets, feats, level)
    print("trilinear sample:", interp.detach().cpu().numpy().ravel())

    # -- sparse conv3d over the octree (spc_conv3d_example.py) --
    kernel_vectors = np.stack(np.meshgrid(*([[-1, 0, 1]] * 3),
                                          indexing="ij"), -1).reshape(-1, 3)
    n_leaf = int(pyramids[0][0][level])
    x = torch.ones((n_leaf, 2), device=device)
    conv = spc_ops.Conv3d(2, 4, kernel_vectors, jump=0,
                          generator=torch.Generator().manual_seed(0))
    if conv_weight is not None:
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(np.asarray(conv_weight)))
    conv = conv.to(device)
    y, _lvl = conv(octree, point_hierarchy, level, pyramids, exsum, x)
    print("conv3d:", tuple(x.shape), "->", tuple(y.shape))
    return {"octree": octree, "pidx": pidx, "interp": interp, "y": y,
            "dual": dual, "trinkets": trinkets}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
