"""Packed reductions. Counterpart of ``kaolin_tpu/ops/reduction.py``: see
:func:`kaolin_tpu_torch.ops.batch.packed_simple_sum`."""

from kaolin_tpu_torch.ops.batch import packed_simple_sum  # noqa: F401

__all__ = ["packed_simple_sum"]
