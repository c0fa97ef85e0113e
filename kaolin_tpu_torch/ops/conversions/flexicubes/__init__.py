from kaolin_tpu_torch.ops.conversions.flexicubes.dense import (  # noqa: F401
    dense_extract,
)
from kaolin_tpu_torch.ops.conversions.flexicubes.flexicubes import (  # noqa
    FlexiCubes,
)
