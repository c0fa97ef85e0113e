from kaolin_tpu_torch.render.easy_render.common import (  # noqa: F401
    default_camera,
    default_lighting,
    default_material,
)
from kaolin_tpu_torch.render.easy_render.mesh import (  # noqa: F401
    RenderPass,
    mesh_rasterize_interpolate,
    render_mesh,
)
from kaolin_tpu_torch.render.easy_render.mesh import (  # noqa: F401
    sg_shade,
    texture_sample_materials,
)
from kaolin_tpu_torch.render.easy_render.mesh import (  # noqa: F401
    mesh_rasterize_interpolate_cuda,
    mesh_rasterize_interpolate_nvdiffrast,
)
