from kaolin_tpu_torch.ops.mesh.check_sign import check_sign  # noqa: F401
from kaolin_tpu_torch.ops.mesh.mesh import (  # noqa: F401
    adjacency_matrix,
    average_face_vertex_features,
    compute_vertex_normals,
    index_vertices_by_faces,
    uniform_laplacian,
    unindex_vertices_by_faces,
)
from kaolin_tpu_torch.ops.mesh.tetmesh import (  # noqa: F401
    inverse_vertices_offset,
    subdivide_tetmesh,
)
from kaolin_tpu_torch.ops.mesh.trianglemesh import (  # noqa: F401
    face_areas,
    face_normals,
    packed_face_areas,
    packed_sample_points,
    sample_points,
    subdivide_trianglemesh,
    uniform_laplacian_smoothing,
    vertex_tangents,
)
