from kaolin_tpu_torch.render import camera  # noqa: F401
from kaolin_tpu_torch.render import easy_render  # noqa: F401
from kaolin_tpu_torch.render import lighting  # noqa: F401
from kaolin_tpu_torch.render import materials  # noqa: F401
from kaolin_tpu_torch.render import mesh  # noqa: F401
from kaolin_tpu_torch.render import spc  # noqa: F401
from kaolin_tpu_torch.render.materials import Material, PBRMaterial  # noqa: F401
