"""Device dispatch for the port's kernels.

Counterpart of ``kaolin_tpu/utils/backend.py``. There the question is
whether Pallas runs compiled or interpreted; here it is only where the
tensor lives: a CUDA tensor launches the hand-written kernel, a CPU tensor
takes the kernel's plain PyTorch version. There is no interpreter mode and
no switch.

:func:`resolve_device` is the default of the entry points that make their
own tensors: the CUDA device unless the caller names another.
"""

import torch


def is_cuda(tensor: torch.Tensor) -> bool:
    """True when ``tensor`` lives on a CUDA device."""
    return tensor.is_cuda


def resolve_device(device, what):
    """``device``, or the CUDA device when it is None. Without a CUDA device
    a None raises: ``what`` never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def input_device(x, device, what):
    """``device`` if given, else the device of ``x`` when it is a tensor,
    else the CUDA device (:func:`resolve_device`): an entry point given
    arrays runs on the card unless the CPU is named."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device, what)
