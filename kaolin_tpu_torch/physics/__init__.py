"""Simplicits reduced-order elastodynamics with particle contact, in
PyTorch: counterpart of ``kaolin_tpu.physics`` without skinning training
and RKPM (ROADMAP, Queue A 2b)."""

from kaolin_tpu_torch.physics import common  # noqa: F401
from kaolin_tpu_torch.physics import materials  # noqa: F401
from kaolin_tpu_torch.physics import simplicits  # noqa: F401
from kaolin_tpu_torch.physics import utils  # noqa: F401
