from kaolin_tpu_torch.render.spc.raster import (  # noqa: F401
    RasterSPC,
    build_raster_spc,
    raster_first_hit,
    raster_first_hit_sequence,
)
from kaolin_tpu_torch.render.spc.raytrace import (  # noqa: F401
    cumprod,
    cumsum,
    diff,
    exponential_integration,
    mark_first_hit,
    mark_pack_boundaries,
    prod_reduce,
    raytrace_overflow_report,
    sum_reduce,
    unbatched_raytrace,
)
