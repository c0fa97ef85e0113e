from kaolin_tpu_torch.render.spc.raster import (  # noqa: F401
    RasterSPC,
    build_raster_spc,
    raster_first_hit,
    raster_first_hit_sequence,
)
