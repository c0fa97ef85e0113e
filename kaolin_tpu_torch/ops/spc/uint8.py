"""Bit manipulation helpers for byte-packed octrees.

Counterpart of ``kaolin_tpu/ops/spc/uint8.py``.
"""

import torch

__all__ = ["uint8_to_bits", "uint8_bits_sum", "bits_to_uint8"]


def _shifts(t):
    return torch.arange(8, dtype=torch.uint8, device=t.device)


def uint8_to_bits(uint8_t):
    """uint8 (...,) → bool (..., 8), least significant bit first."""
    return ((uint8_t[..., None] >> _shifts(uint8_t)) & 1).to(torch.bool)


def uint8_bits_sum(uint8_t):
    """Popcount per byte → int32 (...,)."""
    return uint8_to_bits(uint8_t).sum(dim=-1, dtype=torch.int32)


def bits_to_uint8(bool_t):
    """bool (..., 8), least significant bit first → uint8 (...,)."""
    return (bool_t.to(torch.uint8) << _shifts(bool_t)).sum(
        dim=-1, dtype=torch.uint8)
