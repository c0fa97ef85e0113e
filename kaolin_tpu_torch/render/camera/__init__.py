from kaolin_tpu_torch.render.camera.camera import Camera  # noqa: F401
from kaolin_tpu_torch.render.camera.extrinsics import (  # noqa: F401
    CameraExtrinsics,
)
from kaolin_tpu_torch.render.camera.intrinsics import (  # noqa: F401
    CameraFOV,
    CameraIntrinsics,
    OrthographicIntrinsics,
    PinholeIntrinsics,
    down_from_homogeneous,
    up_to_homogeneous,
)
from kaolin_tpu_torch.render.camera.raygen import (  # noqa: F401
    generate_centered_custom_resolution_pixel_coords,
    generate_centered_pixel_coords,
    generate_default_grid,
    generate_ortho_rays,
    generate_pinhole_rays,
    generate_rays,
)
