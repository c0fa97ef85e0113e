from kaolin_tpu_torch.render.camera.camera import Camera, allclose  # noqa: F401
from kaolin_tpu_torch.render.camera.coordinates import (  # noqa: F401
    blender_coords,
    opengl_coords,
)
from kaolin_tpu_torch.render.camera.extrinsics import (  # noqa: F401
    CameraExtrinsics,
)
from kaolin_tpu_torch.render.camera.intrinsics import (  # noqa: F401
    CameraFOV,
    CameraIntrinsics,
    IntrinsicsParamsDefEnum,
    OrthoParamsDefEnum,
    PinholeParamsDefEnum,
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
from kaolin_tpu_torch.render.camera.gsplats import (  # noqa: F401
    gsplat_inria_camera_to_kaolin,
    gsplat_nerfstudio_camera_to_kaolin,
    gsplats_camera_to_kaolin,
    kaolin_camera_to_gsplat_inria,
    kaolin_camera_to_gsplat_nerfstudio,
    kaolin_camera_to_gsplats,
)
from kaolin_tpu_torch.render.camera import legacy  # noqa: F401
from kaolin_tpu_torch.render.camera.legacy import (  # noqa: F401
    generate_perspective_projection,
    generate_rotate_translate_matrices,
    generate_transformation_matrix,
    perspective_camera,
    rotate_translate_points,
)
from kaolin_tpu_torch.render.camera.polyscope import (  # noqa: F401
    kaolin_camera_to_polyscope,
    polyscope_camera_to_kaolin,
)
from kaolin_tpu_torch.render.camera.trajectory import (  # noqa: F401
    camera_path_generator,
    loop_camera_path_generator,
)
from kaolin_tpu_torch.render.camera.extrinsics_backends import (  # noqa: F401
    ExtrinsicsParamsDefEnum,
    ExtrinsicsRep,
    register_backend,
)
