from kaolin_tpu_torch.ops.conversions.flexicubes import (  # noqa: F401
    FlexiCubes,
    dense_extract,
)
from kaolin_tpu_torch.ops.conversions.gaussians import (  # noqa: F401
    gs_to_voxelgrid,
)
from kaolin_tpu_torch.ops.conversions.pointcloud import (  # noqa: F401
    pointclouds_to_voxelgrids,
    unbatched_pointcloud_to_spc,
)
from kaolin_tpu_torch.ops.conversions.sdf import (  # noqa: F401
    sdf_to_voxelgrids,
)
from kaolin_tpu_torch.ops.conversions.tetmesh import (  # noqa: F401
    marching_tetrahedra,
    marching_tetrahedra_fixed,
)
from kaolin_tpu_torch.ops.conversions.trianglemesh import (  # noqa: F401
    trianglemeshes_to_voxelgrids,
    unbatched_mesh_to_spc,
)
from kaolin_tpu_torch.ops.conversions.voxelgrid import (  # noqa: F401
    voxelgrids_to_cubic_meshes,
    voxelgrids_to_trianglemeshes,
)
