"""A run of each cell at a size the CPU holds, through the port's plain
paths: the fit's first steps agree with the reference, and no module of
JAX or of the JAX package is loaded after it."""

import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, SEED, small


@pytest.mark.parametrize("workload", CELLS)
def test_small_run_agrees_with_the_reference(workload):
    out = harness.run_cell(workload, SEED, 0.5, False, "cpu",
                           cfg=small(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"fit_steps_per_s", "setup_s"} <= set(out["metrics"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_jax_after_a_run():
    harness.run_cell("texfit.v8", SEED + 1, 0.2, True, "cpu",
                     cfg=small("texfit.v8"))
    tops = {m.split(".")[0] for m in sys.modules}
    assert not tops & set(harness.JAX_NAMES), tops & set(harness.JAX_NAMES)
    assert "kaolin_tpu_torch" in tops
    assert harness.jax_loaded() == []


def test_the_seed_draws_the_same_sizes():
    from portbench.fits import dibr
    cfg = small("asset.v8")
    mix = harness.cell(harness.benchmark(), "asset.v8")[3]
    a = dibr.make_inputs(cfg, mix, SEED, "cpu")
    b = dibr.make_inputs(cfg, mix, SEED, "cpu")
    c = dibr.make_inputs(cfg, mix, SEED + 5, "cpu")
    for k in a:
        if hasattr(a[k], "shape"):
            assert a[k].shape == c[k].shape
            assert (a[k] == b[k]).all()
    assert not (a["target_texture"] == c["target_texture"]).all()


def test_reference_is_the_same_at_any_pair_limit():
    from portbench.fits import dibr
    from portbench.reference import dibr_fit
    cfg = small("texfit.v8")
    mix = harness.cell(harness.benchmark(), "texfit.v8")[3]
    inputs = dibr.make_inputs(cfg, mix, SEED, "cpu")
    whole = dibr_fit.run(cfg, inputs, 2)
    cfg["reference_pairs"] = 97
    cut = dibr_fit.run(cfg, inputs, 2)
    assert (whole["face_idx"] == cut["face_idx"]).all()
    assert (whole["image"] == cut["image"]).all()
    assert (whole["soft"] - cut["soft"]).abs().max() <= 1e-6
    for k in whole["grad"]:
        assert torch.allclose(whole["grad"][k], cut["grad"][k], rtol=1e-4,
                              atol=1e-7 * float(whole["grad"][k].abs().max()))
