"""Simplicits reduced-order elastodynamics with particle contact, skinning
training and RKPM weights, in PyTorch: counterpart of
``kaolin_tpu.physics``."""

from kaolin_tpu_torch.physics import common  # noqa: F401
from kaolin_tpu_torch.physics import materials  # noqa: F401
from kaolin_tpu_torch.physics import simplicits  # noqa: F401
from kaolin_tpu_torch.physics import utils  # noqa: F401
