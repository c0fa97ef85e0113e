"""The layout of the parallel layer: a 1-D ``DeviceMesh`` whose dimension
names the data-parallel axis, and global tensors sharded on dim 0.

A ``DTensor`` sharded on dim 0 (``Shard(0)``) comes in as its local shard.
A plain tensor is read as the global value, the same on every rank, and
each rank takes its own equal slice of dim 0, as ``jax.device_put`` with a
``P("dp")`` sharding would lay it out; the slice keeps autograd's link to
the tensor. Results go out as ``DTensor``s sharded on dim 0.
"""

import torch
from torch.distributed.tensor import DTensor, Shard


def axis_rank_size(mesh, axis_name):
    """(rank on the axis, size of the axis) of this process."""
    return mesh.get_local_rank(axis_name), mesh.size(
        mesh.mesh_dim_names.index(axis_name))


def local_shard(x, mesh, axis_name="dp"):
    """This rank's dim-0 shard of a global ``x``: the local tensor of a
    ``DTensor`` sharded on dim 0, or the rank's slice of a plain tensor
    (whose dim 0 the axis must divide, as JAX's sharding requires)."""
    if isinstance(x, DTensor):
        if tuple(x.placements) != (Shard(0),):
            raise ValueError(f"expected a DTensor sharded on dim 0, got "
                             f"{x.placements}")
        return x.to_local()
    rank, size = axis_rank_size(mesh, axis_name)
    if x.shape[0] % size:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not divide over "
                         f"the {size} ranks of axis {axis_name!r}")
    k = x.shape[0] // size
    return x[rank * k:(rank + 1) * k]


def sharded(local, mesh):
    """A ``DTensor`` sharded on dim 0 from each rank's equal shard."""
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False)


def all_reduce_mean(t, mesh, axis_name="dp"):
    """The mean of ``t`` over the axis' ranks, by ``all_reduce``."""
    _, size = axis_rank_size(mesh, axis_name)
    t = t.clone()
    torch.distributed.all_reduce(t, group=mesh.get_group(axis_name))
    return t / size
