from kaolin_tpu_torch.physics.simplicits import losses  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import network  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import precomputed  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import rkpm  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import simulation  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import skinning  # noqa: F401
from kaolin_tpu_torch.physics.simplicits import training  # noqa: F401
from kaolin_tpu_torch.physics.simplicits.losses import (  # noqa: F401
    compute_losses,
    loss_elastic,
    loss_ortho,
)
from kaolin_tpu_torch.physics.simplicits.network import (  # noqa: F401
    SimplicitsMLP,
    SkinningFn,
    SkinningModule,
    mlp_apply,
    mlp_init,
)
from kaolin_tpu_torch.physics.simplicits.precomputed import (  # noqa: F401
    dFdz_matrix,
    jacobian_dF_dz,
    lbs_matrix,
    lumped_mass_matrix,
    sparse_collision_jacobian_matrix,
    sparse_dFdz_matrix,
    sparse_dFdz_matrix_from_dense,
    sparse_lbs_matrix,
    sparse_mass_matrix,
)
from kaolin_tpu_torch.physics.simplicits.rkpm import (  # noqa: F401
    RKPM,
    SimplicitsRKPM,
)
from kaolin_tpu_torch.physics.simplicits.simulation import (  # noqa: F401
    SimplicitsScene,
    SimulatedObject,
)
from kaolin_tpu_torch.physics.simplicits.skinning import (  # noqa: F401
    standard_lbs,
    weight_function_lbs,
)
from kaolin_tpu_torch.physics.simplicits.training import (  # noqa: F401
    PhysicsPoints,
    SimplicitsObject,
    SkinnedPhysicsPoints,
    SkinnedPoints,
)

# the reference's Warp fast-path losses are the same functions here
compute_losses_warp = compute_losses
loss_elastic_warp = loss_elastic
