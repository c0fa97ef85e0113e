from kaolin_tpu_torch.metrics import pointcloud  # noqa: F401
from kaolin_tpu_torch.metrics import render  # noqa: F401
from kaolin_tpu_torch.metrics import tetmesh  # noqa: F401
from kaolin_tpu_torch.metrics import trianglemesh  # noqa: F401
from kaolin_tpu_torch.metrics import voxelgrid  # noqa: F401
