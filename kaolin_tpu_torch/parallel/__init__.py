"""Device-mesh parallelism: counterpart of ``kaolin_tpu/parallel``.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension is named ``"dp"`` (``axis_name`` names it), over a process group
of one process a card (NCCL) or a CPU process (gloo). Global inputs and
outputs are ``DTensor``s sharded on dim 0; parameters are replicated plain
tensors; a plain tensor given where a sharded one is expected is read as
the global value and each rank takes its slice (``_dist``). Each rank
computes its own shard:

* batch-parallel rendering and metrics over views or clouds (:mod:`ops`),
  no communication;
* scene-parallel physics, independent scenes stepped as a batch by
  ``torch.func.vmap``, no communication;
* data-parallel skinning-weight training, the one step that communicates:
  its gradients and loss are averaged over ``"dp"`` by ``all_reduce``.
"""

from kaolin_tpu_torch.parallel.ops import (  # noqa: F401
    sharded_chamfer_distance,
    sharded_dibr_rasterization,
)
from kaolin_tpu_torch.parallel.simplicits import (  # noqa: F401
    make_demo_scene,
    sharded_mlp_train_step,
    sharded_scene_batch_step,
    stack_scenes,
)
