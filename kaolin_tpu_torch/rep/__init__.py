from kaolin_tpu_torch.rep.gaussians import (  # noqa: F401
    GaussianSplatModel,
    PointSamples,
)
from kaolin_tpu_torch.rep.tensor_container import (  # noqa: F401
    TensorContainerBase,
)
from kaolin_tpu_torch.rep.spc import Spc  # noqa: F401
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh  # noqa: F401
