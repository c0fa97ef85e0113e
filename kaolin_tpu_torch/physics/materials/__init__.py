from kaolin_tpu_torch.physics.materials import (  # noqa: F401
    linear_elastic_material,
    material_utils,
    neohookean_elastic_material,
)
from kaolin_tpu_torch.physics.materials.material_utils import (  # noqa: F401
    get_defo_grad,
    to_lame,
)
from kaolin_tpu_torch.physics.materials.neohookean_elastic_material import (  # noqa: F401, E501
    NeohookeanElasticMaterial,
)
