"""Sharded geometry ops: the batch axis sharded over the mesh's ``"dp"``
axis.

Counterpart of ``kaolin_tpu/parallel/ops.py``. Each rank computes the views
or clouds of its own shard with the port's single-device function; nothing
is communicated. On the card :func:`sharded_dibr_rasterization` runs
kernels #1-3 (the winner search and the soft mask forward and backward)
through ``dibr_rasterization``, and autograd flows through it to the
inputs.
"""

from kaolin_tpu_torch.metrics.pointcloud import chamfer_distance
from kaolin_tpu_torch.parallel._dist import local_shard, sharded

__all__ = ["sharded_chamfer_distance", "sharded_dibr_rasterization"]


def sharded_chamfer_distance(mesh, p1, p2, w1=1.0, w2=1.0, squared=True):
    """Chamfer distance (B,) of clouds (B, N, 3) and (B, M, 3) with B
    sharded over the mesh's ``"dp"`` axis → a ``DTensor`` sharded on dim
    0."""
    return sharded(chamfer_distance(local_shard(p1, mesh),
                                    local_shard(p2, mesh), w1=w1, w2=w2,
                                    squared=squared), mesh)


def sharded_dibr_rasterization(mesh, height, width, face_vertices_z,
                               face_vertices_image, face_features,
                               face_normals_z, **kwargs):
    """Multi-view DIB-R with the view axis sharded over the mesh's ``"dp"``
    axis: the geometry is replicated in every view's inputs, the views are
    sharded, and gradients reduce over views outside. ``face_features``
    may be a list, as ``dibr_rasterization`` takes it. → (image, soft
    mask, face ids), each tensor a ``DTensor`` sharded on dim 0."""
    from kaolin_tpu_torch.render.mesh.dibr import dibr_rasterization

    outs = dibr_rasterization(
        height, width, *(_tree_map(lambda x: local_shard(x, mesh), x)
                         for x in (face_vertices_z, face_vertices_image,
                                   face_features, face_normals_z)),
        **kwargs)
    return _tree_map(lambda o: sharded(o, mesh), tuple(outs))


def _tree_map(fn, x):
    """``fn`` on every tensor of ``x``, through lists and tuples (DIB-R's
    features and its image may be lists, as JAX's pytrees are)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)
