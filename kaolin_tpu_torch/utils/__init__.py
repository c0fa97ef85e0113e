from kaolin_tpu_torch.utils import testing  # noqa: F401
from kaolin_tpu_torch.utils.backend import is_cuda  # noqa: F401
from kaolin_tpu_torch.utils.cuda_gather import (  # noqa: F401
    gather_route,
    table_gather,
    table_gather_plain,
)
from kaolin_tpu_torch.utils.interop import (  # noqa: F401
    collision_from_jax,
    contacts_from_jax,
    from_numpy_tree,
    graph_conv_from_jax,
    pbr_material_from_jax,
    sg_lighting_from_jax,
    surface_mesh_from_jax,
)
from kaolin_tpu_torch.utils.profiling import (  # noqa: F401
    Timing,
    sync,
    time_fn,
    trace,
)
