"""USD I/O of the port: the USDA text and Crate binary layers, ``.usdz``
packages, and the material registry. Counterpart of ``kaolin_tpu/io/usd``."""

from kaolin_tpu_torch.io.usd.core import (  # noqa: F401
    UsdaStage,
    add_mesh,
    add_pointcloud,
    add_voxelgrid,
    create_stage,
    export_mesh,
    export_meshes,
    export_pointcloud,
    get_face_uvs_idx,
    get_uvmap_primvar,
    import_mesh,
    import_meshes,
    import_pointcloud,
)
from kaolin_tpu_torch.io.usd.core import (  # noqa: F401
    add_gaussiancloud,
    add_physics_material,
    add_skinned_physics,
    export_gaussiancloud,
    get_physics_material,
    get_skinned_physics,
    set_normals,
    import_gaussiancloud,
    import_gaussianclouds,
    import_voxelgrid,
)
from kaolin_tpu_torch.io.usd.core import (  # noqa: F401
    export_pointclouds,
    export_voxelgrid,
    export_voxelgrids,
    get_authored_time_samples,
    get_gaussiancloud_scene_paths,
    get_mesh_scene_paths,
    get_pointcloud_bracketing_time_samples,
    get_pointcloud_scene_paths,
    get_scene_paths,
    import_pointclouds,
    import_voxelgrids,
    read_usd_preview_surface,
    write_usd_preview_surface,
)
from kaolin_tpu_torch.io.usd.core import add_subset, import_subsets  # noqa: F401
from kaolin_tpu_torch.io.usd.core import (  # noqa: F401
    export_material,
    get_all_physics_materials,
    get_all_skinned_physics,
    get_local_to_world_transform,
    get_mesh_prim_materials,
    get_physics_materials_instance_names,
    get_raw_mesh_prim_geometry,
    get_skinned_physics_instance_names,
    import_material,
    set_local_to_world_transform,
)
from kaolin_tpu_torch.io.usd.materials import (  # noqa: F401
    MaterialLoadError,
    MaterialNotFoundError,
    UsdMaterialIoManager,
)
