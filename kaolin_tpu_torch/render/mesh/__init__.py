from kaolin_tpu_torch.render.mesh.dibr import (  # noqa: F401
    dibr_rasterization,
    dibr_soft_mask,
)
from kaolin_tpu_torch.render.mesh.rasterization import rasterize  # noqa: F401
