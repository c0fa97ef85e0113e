"""Random data generators for tests and sampling.

Counterpart of ``kaolin_tpu/ops/random.py``. Every draw takes a
``torch.Generator`` (``key``) where JAX takes a PRNG key, and happens on
the generator's device; without one, a generator on ``device`` (the CUDA
device unless named) is seeded from Python's ``random``.
"""

import random as _py_random

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.uint8 import uint8_to_bits  # noqa: F401
from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "manual_seed",
    "random_shape_per_tensor",
    "random_tensor",
    "random_spc_octrees",
    "sample_spherical_coords",
]


def manual_seed(seed, random_seed=None, numpy_seed=None, device=None):
    """Seed Python's, numpy's and torch's generators → a
    ``torch.Generator`` on ``device`` (the CUDA device unless named) seeded
    with ``seed``."""
    device = resolve_device(device, "manual_seed")
    _py_random.seed(seed if random_seed is None else random_seed)
    np.random.seed((seed if numpy_seed is None else numpy_seed) % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(device).manual_seed(seed)


def _generator(key, device, what):
    if key is not None:
        return key
    return torch.Generator(resolve_device(device, what)).manual_seed(
        _py_random.randint(0, 2 ** 31 - 1))


def random_shape_per_tensor(batch_size, min_shape=None, max_shape=None):
    """Random shape_per_tensor (numpy host metadata), each entry drawn by
    Python's ``random`` in [min, max]."""
    if max_shape is None:
        raise ValueError("max_shape must be provided")
    if min_shape is None:
        min_shape = [1] * len(max_shape)
    return np.stack([
        np.array([_py_random.randint(lo, hi)
                  for lo, hi in zip(min_shape, max_shape)])
        for _ in range(batch_size)])


def random_tensor(low, high, shape, dtype=torch.float32, key=None,
                  device=None):
    """A tensor of ``shape`` drawn uniformly: integers in [low, high] (high
    included), floats in [low, high), on the generator's device."""
    gen = _generator(key, device, "random_tensor")
    if not dtype.is_floating_point:
        return torch.randint(low, high + 1, tuple(shape), generator=gen,
                             dtype=dtype, device=gen.device)
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                   device=gen.device)
    return u * (high - low) + low


def random_spc_octrees(batch_size, max_level, key=None, device=None):
    """Random byte octrees → (octrees uint8 (sum of lengths,), lengths
    (batch_size,) int32): each from 8 to 64 points (Python's ``random``)
    uniform in [−1, 1)³, quantized at ``max_level``."""
    from kaolin_tpu_torch.ops.spc.points import (
        quantize_points,
        unbatched_points_to_octree,
    )
    gen = _generator(key, device, "random_spc_octrees")
    octrees, lengths = [], []
    for _ in range(batch_size):
        num_pts = _py_random.randint(8, 64)
        pts = torch.rand((num_pts, 3), generator=gen,
                         device=gen.device) * 2.0 - 1.0
        octree = unbatched_points_to_octree(quantize_points(pts, max_level),
                                            max_level)
        octrees.append(octree)
        lengths.append(octree.shape[0])
    return torch.cat(octrees), torch.tensor(lengths, dtype=torch.int32,
                                            device=gen.device)


def sample_spherical_coords(shape, azimuth_low=0., azimuth_high=2 * np.pi,
                            elevation_low=0., elevation_high=np.pi / 2.,
                            key=None, device=None):
    """Azimuth uniform in [low, high), elevation uniform *on the sphere*
    (the arcsin of a uniform draw of its sine) → (azimuth, elevation)."""
    gen = _generator(key, device, "sample_spherical_coords")
    shape = tuple(shape)
    azimuth = torch.rand(shape, generator=gen, device=gen.device) \
        * (azimuth_high - azimuth_low) + azimuth_low
    sin_lo, sin_hi = np.sin(elevation_low), np.sin(elevation_high)
    u = torch.rand(shape, generator=gen, device=gen.device)
    elevation = torch.asin(u * float(sin_hi - sin_lo) + float(sin_lo))
    return azimuth, elevation


def get_state():
    """Snapshot torch's (CPU), numpy's and Python's generator states."""
    return (torch.get_rng_state(), np.random.get_state(),
            _py_random.getstate())


def set_state(state):
    """Restore a state from :func:`get_state`."""
    torch_state, np_state, py_state = state
    torch.set_rng_state(torch_state)
    np.random.set_state(np_state)
    _py_random.setstate(py_state)
