"""Legacy exsum layout shim.

Counterpart of ``kaolin_tpu/ops/spc/exsum_compat.py`` (host numpy, as
there): older code produced per-octree exsum blocks of length
``num_bytes + 1`` (a leading 0); the current convention is length
``num_bytes`` with ``exsum[i]`` the inclusive bit count through byte ``i``.
These helpers detect and convert between the two, so legacy tensors keep
working. A tensor comes back as a tensor on its device.
"""

import warnings

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import host

__all__ = [
    "octree_byte_lengths_from_pyramid",
    "ensure_current_exsum",
    "current_to_legacy",
]

_DEPRECATION_MSG = (
    "{caller} received a legacy `exsum`/`prefix_sum` of length "
    "(num_bytes + batch_size). The exsum convention changed to length "
    "num_bytes (exsum[i] is the inclusive bit-count sum through byte i). "
    "Legacy support is deprecated; regenerate with scan_octrees.")


def _like(result, exsum):
    """``result`` (numpy) as a tensor on ``exsum``'s device when ``exsum``
    is a tensor."""
    if isinstance(exsum, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(result)).to(exsum.device)
    return result


def octree_byte_lengths_from_pyramid(pyramids):
    """Per-octree byte counts from pyramids (B, 2, max_level + 2) → (B,)
    int64 numpy."""
    pyramids = host(pyramids)
    counts = pyramids[:, 0, :]
    cumsum = pyramids[:, 1, :]
    max_level = np.maximum((counts != 0).sum(axis=1), 1) - 1
    return cumsum[np.arange(pyramids.shape[0]), max_level].astype(np.int64)


def _legacy_to_current(exsum, octree_lengths):
    """Drop the leading 0 of each per-octree block."""
    ex = host(exsum)
    lengths = np.asarray(host(octree_lengths), dtype=np.int64)
    if lengths.size == 1:
        return _like(ex[1:], exsum)
    block_sizes = lengths + 1
    block_starts = np.zeros(lengths.size, dtype=np.int64)
    block_starts[1:] = np.cumsum(block_sizes)[:-1]
    keep = np.ones(ex.shape[0], dtype=bool)
    keep[block_starts] = False
    return _like(ex[keep], exsum)


def current_to_legacy(exsum, octree_lengths):
    """Prepend a leading 0 to each per-octree block."""
    ex = host(exsum)
    lengths = np.asarray(host(octree_lengths), dtype=np.int64)
    parts = []
    offset = 0
    for length in lengths.tolist():
        parts.append(np.zeros(1, dtype=ex.dtype))
        parts.append(ex[offset:offset + int(length)])
        offset += int(length)
    return _like(np.concatenate(parts), exsum)


def ensure_current_exsum(exsum, octree_lengths, caller):
    """``exsum`` in the current layout, converted (with a
    DeprecationWarning) if it is legacy."""
    lengths = host(octree_lengths)
    num_bytes = int(lengths.sum())
    batch_size = lengths.size
    n = int(exsum.shape[0])
    if n == num_bytes:
        return exsum
    if n == num_bytes + batch_size:
        warnings.warn(_DEPRECATION_MSG.format(caller=caller),
                      DeprecationWarning)
        return _legacy_to_current(exsum, lengths)
    raise ValueError(
        f"{caller}: exsum length {n} matches neither the current layout "
        f"({num_bytes}) nor the legacy layout ({num_bytes + batch_size})")
