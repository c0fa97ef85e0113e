"""Newton-engine bridge: Simplicits soft bodies coupled to rigid colliders.

Counterpart of ``kaolin_tpu/experimental/newton``. The external NVIDIA
Newton engine is replaced by a minimal rigid-shape set (:mod:`shapes`) with
the same contact data. Plain PyTorch, no kernel: the model is built on the
card unless ``finalize(device=...)`` names another device.
"""

from kaolin_tpu_torch.experimental.newton.builder import (  # noqa: F401
    SimplicitsModelBuilder,
)
from kaolin_tpu_torch.experimental.newton.collisions import (  # noqa: F401
    ParticleShapeSoftContact,
)
from kaolin_tpu_torch.experimental.newton.model import (  # noqa: F401
    SimplicitsModel,
    SimplicitsState,
)
from kaolin_tpu_torch.experimental.newton.shapes import (  # noqa: F401
    RigidShapes,
)
from kaolin_tpu_torch.experimental.newton.solver import (  # noqa: F401
    SimplicitsSolver,
)
