"""On the card, at each cell's own size: the control (the reference in
TF32, put in the program's place) comes out not correct, and a short run
of the program comes out correct with every metric it reports. They skip
where there is no CUDA device; on the chip:

    python -m pytest portbench/tests/test_portbench_card.py
"""

import pytest

from portbench import harness
from portbench.fits import dibr
from portbench.reference import dibr_fit
from portbench.reference.compare import judge
from portbench.tests.conftest import CELLS, SEED


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    _, _, cfg, mix = harness.cell(harness.benchmark(), workload)
    for seed in (SEED, SEED + 1, SEED + 2):
        inputs = dibr.make_inputs(cfg, mix, seed, card)
        ref = dibr_fit.run(cfg, inputs, cfg["checked_steps"])
        control = dibr_fit.run(cfg, inputs, cfg["checked_steps"], tf32=True)
        correct, rows = judge(dibr_fit.numbers(control, ref), cfg["limits"])
        assert not correct, rows


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_short_run_is_correct(card, workload, trace):
    bench = harness.benchmark()
    out = harness.run_cell(workload, SEED + 3, 4.0, trace, card, bench=bench)
    assert out["correct"], out["checks"]
    wanted = {m["name"] for m in harness.metrics_of(bench, workload, trace)}
    assert set(out["metrics"]) == wanted
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"]["dibr_kernels_roofline"]["value"] < 100
