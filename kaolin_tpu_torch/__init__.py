"""kaolin_tpu_torch — the PyTorch + CUDA port of ``kaolin_tpu``.

The port carries the DIB-R inverse-rendering step today:
:func:`kaolin_tpu_torch.render.mesh.dibr_rasterization` (winner search,
differentiable re-gather, soft silhouette) and
:func:`kaolin_tpu_torch.metrics.render.mask_iou`. Each Pallas kernel of that
path is a hand-written CUDA kernel for Hopper (``sm_90a``), built from the
``csrc`` sources at first use; a tensor on the CPU takes the kernel's plain
PyTorch version instead.

``kaolin_tpu`` stays the reference. This package imports neither it nor jax.
"""

__version__ = "0.1.0"

from kaolin_tpu_torch import metrics  # noqa: F401
from kaolin_tpu_torch import render   # noqa: F401
from kaolin_tpu_torch import utils    # noqa: F401
