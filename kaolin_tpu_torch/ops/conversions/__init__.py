from kaolin_tpu_torch.ops.conversions.pointcloud import (  # noqa: F401
    pointclouds_to_voxelgrids,
    unbatched_pointcloud_to_spc,
)
from kaolin_tpu_torch.ops.conversions.trianglemesh import (  # noqa: F401
    trianglemeshes_to_voxelgrids,
    unbatched_mesh_to_spc,
)
