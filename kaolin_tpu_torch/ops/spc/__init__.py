from kaolin_tpu_torch.ops.spc.points import (  # noqa: F401
    coords_to_trilinear,
    coords_to_trilinear_coeffs,
    create_dense_spc,
    morton_to_octree,
    morton_to_points,
    points_to_corners,
    points_to_morton,
    quantize_points,
    unbatched_interpolate_trilinear,
    unbatched_points_to_octree,
)
from kaolin_tpu_torch.ops.spc.spc import (  # noqa: F401
    feature_grids_to_spc,
    generate_points,
    scan_octrees,
    to_dense,
    unbatched_get_level_points,
    unbatched_make_dual,
    unbatched_make_trinkets,
    unbatched_query,
)
from kaolin_tpu_torch.ops.spc import uint8  # noqa: F401
from kaolin_tpu_torch.ops.spc.uint8 import (  # noqa: F401
    bits_to_uint8,
    uint8_bits_sum,
    uint8_to_bits,
)
from kaolin_tpu_torch.ops.spc.convolution import (  # noqa: F401
    Conv3d,
    ConvTranspose3d,
    conv3d,
    conv_transpose3d,
)
from kaolin_tpu_torch.ops.spc.bf_recon import (  # noqa: F401
    bf_recon,
    build_mip2d,
    extract_bq,
    fuse_bf,
    process_frame,
)
from kaolin_tpu_torch.ops.spc.raytraced_spc_dataset import (  # noqa: F401
    RayTracedSPCDataset,
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
