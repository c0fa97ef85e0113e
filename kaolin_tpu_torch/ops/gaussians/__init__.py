from kaolin_tpu_torch.ops.gaussians.densifier import (  # noqa: F401
    sample_points_in_volume,
)
from kaolin_tpu_torch.ops.gaussians.transforms import (  # noqa: F401
    transform_gaussians,
    transform_shs,
)
