"""Shared pieces of the kaolin_tpu_torch parity tests (``test_torch_*.py``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def warm_torch_exp():
    """Run torch.exp once on a tensor small enough for one thread.

    With jax imported in the same process, torch 2.13's first ``torch.exp``
    on a CPU tensor large enough to be split over threads returned values up
    to 1e-4 off in 4 of 30 fresh processes; later calls were exact. A first
    call on one thread avoided it in 30 of 30. Import this fixture into a
    test module to apply it there."""
    torch.exp(torch.zeros(8))


def grid_faces(n=4, step=0.125):
    """A grid of n x n square cells, each split along a diagonal →
    (1, 2n², 3, 2) float32. At 32² every pixel centre on a diagonal sits on
    an edge two faces share, where their z and their distance candidates
    tie exactly."""
    faces = []
    for i in range(n):
        for j in range(n):
            x0, y0 = (i - n / 2) * step, (j - n / 2) * step
            a, b = (x0, y0), (x0 + step, y0)
            c, d = (x0, y0 + step), (x0 + step, y0 + step)
            faces += [[a, b, d], [a, d, c]]
    return np.asarray(faces, np.float32)[None]


def load_example():
    """``examples/torch_dibr_optimization.py`` as a module."""
    path = os.path.join(ROOT, "examples", "torch_dibr_optimization.py")
    spec = importlib.util.spec_from_file_location("torch_dibr_optimization",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
