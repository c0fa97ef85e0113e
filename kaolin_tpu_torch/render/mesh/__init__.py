from kaolin_tpu_torch.render.mesh.deftet import deftet_sparse_render  # noqa: F401
from kaolin_tpu_torch.render.mesh.nvdiffrast_context import (  # noqa: F401
    default_nvdiffrast_context,
    nvdiffrast_is_available,
)
from kaolin_tpu_torch.render.mesh.dibr import (  # noqa: F401
    dibr_rasterization,
    dibr_soft_mask,
)
from kaolin_tpu_torch.render.mesh.rasterization import (  # noqa: F401
    rasterize,
    suggest_tile_cap,
    tile_overflow_report,
)
from kaolin_tpu_torch.render.mesh.utils import (  # noqa: F401
    prepare_vertices,
    spherical_harmonic_lighting,
    texture_mapping,
)
