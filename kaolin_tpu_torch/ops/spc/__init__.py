from kaolin_tpu_torch.ops.spc.points import (  # noqa: F401
    morton_to_octree,
    morton_to_points,
    points_to_corners,
    points_to_morton,
    quantize_points,
    unbatched_points_to_octree,
)
from kaolin_tpu_torch.ops.spc.spc import (  # noqa: F401
    generate_points,
    scan_octrees,
    unbatched_get_level_points,
)
from kaolin_tpu_torch.ops.spc import uint8  # noqa: F401
from kaolin_tpu_torch.ops.spc.uint8 import (  # noqa: F401
    bits_to_uint8,
    uint8_bits_sum,
    uint8_to_bits,
)
