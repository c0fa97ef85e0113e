"""Device dispatch for the port's kernels.

Counterpart of ``kaolin_tpu/utils/backend.py``. There the question is
whether Pallas runs compiled or interpreted; here it is only where the
tensor lives: a CUDA tensor launches the hand-written kernel, a CPU tensor
takes the kernel's plain PyTorch version. There is no interpreter mode and
no switch.
"""

import torch


def is_cuda(tensor: torch.Tensor) -> bool:
    """True when ``tensor`` lives on a CUDA device."""
    return tensor.is_cuda
