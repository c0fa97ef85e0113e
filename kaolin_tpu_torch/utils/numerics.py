"""Elementwise helpers that keep the JAX package's gradient rules."""

import torch

__all__ = ["clip"]


def clip(x, lo=None, hi=None):
    """``jnp.clip`` with its gradient: where ``x`` equals a bound, the
    gradient is split evenly between ``x`` and the bound, so ``x`` gets half
    of it (``torch.clamp`` gives ``x`` all of it). Built from
    ``torch.maximum`` and ``torch.minimum``, which split ties as JAX's
    ``max`` and ``min`` do."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x
