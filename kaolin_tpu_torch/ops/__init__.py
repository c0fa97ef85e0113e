from kaolin_tpu_torch.ops import batch  # noqa: F401
from kaolin_tpu_torch.ops import conversions  # noqa: F401
from kaolin_tpu_torch.ops import gaussians  # noqa: F401
from kaolin_tpu_torch.ops import mesh  # noqa: F401
from kaolin_tpu_torch.ops import pointcloud  # noqa: F401
from kaolin_tpu_torch.ops import spc  # noqa: F401
from kaolin_tpu_torch.ops import voxelgrid  # noqa: F401
from kaolin_tpu_torch.ops.mesh import check_sign  # noqa: F401
from kaolin_tpu_torch.ops.pointcloud import (  # noqa: F401
    center_points,
    farthest_point_sampling,
)
from kaolin_tpu_torch.ops import coords  # noqa: F401
from kaolin_tpu_torch.ops import gcn  # noqa: F401
from kaolin_tpu_torch.ops import random  # noqa: F401
from kaolin_tpu_torch.ops import reduction  # noqa: F401
