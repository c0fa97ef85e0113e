from kaolin_tpu_torch.physics.common import (  # noqa: F401
    optimization,
    scene_forces,
)
from kaolin_tpu_torch.physics.common.optimization import (  # noqa: F401
    newtons_method,
)
from kaolin_tpu_torch.physics.common.scene_forces import (  # noqa: F401
    Boundary,
    Floor,
    Gravity,
)
