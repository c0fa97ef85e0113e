"""Helpers that keep the JAX package's semantics: ``clip`` with its
gradient rule, and the index operations that JAX spells with static sizes
or ``np.unique``, done on the device with no host read."""

import torch

__all__ = ["clip", "nonzero_static", "rank_map", "unique_pairs"]


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


def nonzero_static(mask, size, fill_value=-1):
    """``jnp.nonzero(mask, size=size, fill_value=fill_value)[0]`` of the
    flattened ``mask`` without a host read → (size,) int64: the indices of
    its true elements in ascending order, the first ``size`` of them, then
    ``fill_value``. A ``cumsum`` gives each true element its slot; every
    element past ``size`` and every false one writes into one extra slot,
    which is dropped."""
    flat = mask.reshape(-1)
    pos = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=flat.device)
    out.scatter_(0, slot, torch.arange(flat.shape[0], device=flat.device))
    return out[:size]


def rank_map(mask):
    """``m = full(-1); m[mask] = arange(mask.sum())`` for a 1-D ``mask``."""
    return torch.where(mask, torch.cumsum(mask.long(), 0) - 1, -1)


def unique_pairs(pairs, n):
    """``np.unique(pairs, axis=0, return_inverse=True, return_counts=True)``
    for (K, 2) ids in ``[0, n)``: one int64 key a row keeps the rows'
    lexicographic order → (unique (U, 2), inverse (K,), counts (U,))."""
    uniq, inv, counts = torch.unique(pairs[:, 0] * n + pairs[:, 1],
                                     return_inverse=True, return_counts=True)
    return torch.stack([uniq // n, uniq % n], dim=1), inv, counts
