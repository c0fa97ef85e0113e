"""Shared pieces of the benchmark's own tests (run on the CPU by
``python -m pytest portbench/tests``; the tests that need the card skip
here)."""

import copy

import pytest
import torch

from portbench import harness

CELLS = ("texfit.v8", "asset.v8")
SEED = 2 ** 31 + 977


def small(workload):
    """The cell's configuration at a size a CPU test holds: a 10 x 16
    sphere, a 16² texture, 32² pixels."""
    _, _, cfg, _ = harness.cell(harness.benchmark(), workload)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"] = {"kind": "uv_sphere", "n_lat": 10, "n_lon": 16}
    cfg["texture_size"] = 16
    cfg["res"] = 32
    return cfg


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
