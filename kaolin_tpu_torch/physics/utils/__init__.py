from kaolin_tpu_torch.physics.utils.finite_diff import (  # noqa: F401
    finite_diff_jac,
)
from kaolin_tpu_torch.physics.utils.torch_utilities import (  # noqa: F401
    create_projection_matrix,
    hess_reduction,
    standard_transform_to_relative,
)
