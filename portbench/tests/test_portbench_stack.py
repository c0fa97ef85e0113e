"""The Simplicits contact stack, as the cell ``stack10k.e100`` runs it: the
fit's inputs, build, frames and first steps at a size the CPU holds, a run
through the port's eager path that comes out correct, every planted fault
not correct, an overflowing frame counted as failed, the step's roofline
against a count by hand, the readers of its per-layer metrics on a trace
made up here (None where the port keeps no such record), and a reference
that loads without the port. On the card (skipped here): the control, the
reference in TF32, is not correct, and a short run is correct with every
metric it reports.

    python -m pytest portbench/tests/test_portbench_stack.py
"""

import subprocess
import sys

import pytest
import torch

from kaolin_tpu_torch.utils import profiling
from portbench import harness, traffic
from portbench.fits import simplicits_contact as fit
from portbench.reference import simplicits_contact_fit as ref_fit
from portbench.reference.simplicits_contact import Stack, frames, steps_from
from portbench.reference.compare import judge
from portbench.roofline import simplicits_contact as roof
from portbench.tests.conftest import SEED
from portbench.tests.test_portbench_trace import Ev
from portbench.trace import WINDOW, Trace

MS = 1_000_000
CELL = "stack10k.e100"
MIX = traffic.load("stack_e100")
CONTACTS = "physics.collision.contacts"


def config():
    return harness.cell(harness.benchmark(), CELL)[2]


def small(frames=30):
    """The configuration at a CPU test's size and the cell's density of
    points: 2 cubes of side 0.2 and 80 points, 4 handles, one 5 cm over
    the other, an 8 x 8 plate of side 0.4 that they reach after 9 frames,
    ``frames`` checked frames."""
    cfg = config()
    cfg.update(cubes=2, ring_size=1, ring_radius=0.0, ring_base=-0.3,
               ring_step=0.25, cube_side=0.2, samples=80, handles=4,
               plate_points=64, plate_extent=0.2, checked_steps=frames,
               warmup_steps=2)
    return cfg


def test_inputs_come_from_the_seed_and_never_change_a_shape():
    cfg = small()
    a = fit.make_inputs(cfg, MIX, SEED, "cpu")
    b = fit.make_inputs(cfg, MIX, SEED, "cpu")
    c = fit.make_inputs(cfg, MIX, SEED + 1, "cpu")
    assert a["episode_frames"] == 100 and len(a["cubes"]) == 2
    assert torch.equal(a["plate"], c["plate"]) and a["plate"].shape == (64, 3)
    for x, y, z in zip(a["cubes"], b["cubes"], c["cubes"]):
        for k in ("pts", "weights", "dwdx"):
            assert torch.equal(x[k], y[k])
            assert x[k].shape == z[k].shape and not torch.equal(x[k], z[k])
        assert torch.equal(x["weights"][:, -1], torch.ones(80))
    # the cubes lie in their own boxes, the second above the first
    for i, cube in enumerate(a["cubes"]):
        centre = torch.tensor(fit.centre(cfg, i))
        assert float((cube["pts"] - centre).abs().max()) <= 0.1
    assert fit.centre(cfg, 1)[1] - fit.centre(cfg, 0)[1] == pytest.approx(
        cfg["ring_step"])


def test_frames_step_reset_and_record_the_check():
    """A frame steps the scene once and gives the cubes' points and a
    finite loss; the episode resets after its last frame; the first steps
    keep each frame's start, points and energy."""
    cfg = small()
    inputs = fit.make_inputs(cfg, MIX, SEED, "cpu")
    state = fit.build(cfg, inputs, "cpu")
    scene = state["scene"]
    assert scene.force_dict["collision"]["object"].max_contacts \
        == min(cfg["max_contact_pairs"], 224 * 223 // 2)
    state["episode_frames"] = 3
    for frame in range(3):
        loss, out = fit.step(state)
        assert bool(torch.isfinite(loss))
        assert [p.shape for p in out["pts"]] == [(80, 3), (80, 3)]
    assert scene.current_sim_step == 0 and state["frame"] == 3
    rec = fit.first_steps(state, 2)
    assert len(rec["starts"]) == len(rec["pts"]) == len(rec["energy"]) == 2
    disp, vel = rec["starts"][0]
    assert disp.dtype == torch.float64 and disp.shape == (3 * 160,)
    geo = fit.geometry(state)
    assert geo["contact_capacity"] == scene.force_dict["collision"][
        "object"].max_contacts


def test_small_run_agrees_with_the_reference():
    out = harness.run_cell(CELL, SEED, 0.5, False, "cpu", cfg=small())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(ref_fit.NUMBERS)
    assert {"fit_steps_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", ("stiffness_half", "friction_0"))
def test_planted_physics_fault_is_not_correct(fault):
    """The reference with a fault planted from the first frame, put in the
    program's place (the fault from frame 40 on is the card's test: the
    small stack comes to rest, where friction no longer acts, too soon
    after frame 40 to hold most frames)."""
    cfg = small()
    inputs = fit.make_inputs(cfg, MIX, SEED, "cpu")
    want = ref_fit.run(cfg, inputs, cfg["checked_steps"])
    bad = ref_fit.run(cfg, inputs, cfg["checked_steps"], fault=fault)
    correct, rows = judge(ref_fit.numbers(bad, want), cfg["limits"])
    assert not correct, rows


def test_batched_steps_are_the_single_steps():
    """In float64 the reference's batch of frames steps each frame as it
    would alone, up to the order of float sums: the first frames from
    rest, stepped one at a time, and all at once from their starts."""
    cfg = small(frames=12)
    inputs = fit.make_inputs(cfg, MIX, SEED, "cpu")
    stack = Stack(cfg, inputs, torch.float64)
    starts, pts, energy = frames(lambda i: stack, 12, 100)
    got_pts, got_energy, pairs = steps_from(stack, starts, 100)
    assert int(pairs.sum()) > 0
    for i in range(12):
        assert float((got_pts[i] - pts[i]).abs().max()) < 1e-9, i
        assert abs(float(got_energy[i] - energy[i])) \
            < 1e-9 * abs(float(energy[i])), i


def test_an_overflowing_frame_is_failed():
    """A contact buffer of 2 pairs overflows at the first frame: its loss
    is nan and counts in ``failed``."""
    cfg = small(frames=2)
    cfg["max_contact_pairs"] = 2
    out = harness.run_cell(CELL, SEED, 0.2, False, "cpu", cfg=cfg)
    assert out["failed"] >= 1


def test_roofline_against_a_count_by_hand():
    """One cube of two points, one handle (D_o = 12, D = 24), a plate of
    one point, one line-search step; 3 live pairs and 2 iterations a
    step, a grid of 4 occupied cells of 8 slots."""
    cfg = {"cubes": 1, "samples": 2, "handles": 1, "max_ls_steps": 1,
           "plate_points": 1}
    rows, d_o, d = 24, 12, 24
    got = roof.phases(cfg, live=3, iterations=2, occupied_cells=4,
                      cell_capacity=8)
    assert got == {
        "detection": (4 * (6 * 3 + 8 * 4 * 8), 0),
        "hessian": (2 * 4 * (rows * d_o + d_o * d_o),
                    2 * 2 * d_o * d_o * rows),
        "gradient": (2 * 4 * rows * d_o, 2 * 4 * rows * d_o),
        "line_search": (2 * 4 * rows * d_o, 2 * 2 * rows * d_o * 3),
        "contacts": (2 * 3 * 4 * (8 + 6),
                     2 * 3 * (2 * 24 * 24 * 3 + 2 * 24 * 3 * 5 + 200)),
        "solve": (2 * 4 * (2 * d * d + 2 * d), 2 * (d ** 3 + 4 * d * d))}
    hbm, fp32 = roof.PEAKS["hbm_bytes_per_s"], roof.PEAKS["fp32_ops_per_s"]
    want = 1e3 * sum(max(b / hbm, o / fp32) for b, o in got.values())
    assert roof.bound_ms(cfg, 3, 2, 4, 8) == pytest.approx(want)
    # the cell at 20,000 live pairs and 5 iterations: contacts and the
    # Hessians' reductions bound it, under a millisecond
    cell = config()
    ms = roof.bound_ms(cell, 20_000, 5, 2_000, 16)
    assert 0.2 < ms < 1.0


def _trace():
    """A 100-ms window of 2 frames: a detection graph's replay launched at
    10 ms inside both the port's step and detect spans, a Newton graph's
    at 20 ms inside the step span only; a copy at 60 ms outside both."""
    ev = [Ev("cpu_annotation", WINDOW, 0, 100 * MS),
          Ev("cuda_runtime", "cudaGraphLaunch", 10 * MS, 11 * MS, 1),
          Ev("cuda_runtime", "cudaGraphLaunch", 20 * MS, 21 * MS, 2),
          Ev("cuda_runtime", "cudaMemcpyAsync", 60 * MS, 61 * MS, 3),
          Ev("gpu_kernel", "void radixSortKernel", 12 * MS, 16 * MS, 1),
          Ev("gpu_kernel", "void kernel<getrf_wo_pivot_params_<float>>",
             22 * MS, 24 * MS, 2),
          Ev("gpu_kernel", "void getrf_pivot<float>", 24 * MS, 26 * MS, 2),
          Ev("gpu_kernel", "cutlass_80_simt_sgemm_128x256", 26 * MS,
             30 * MS, 2),
          Ev("gpu_memcpy", "Memcpy DtoH", 62 * MS, 63 * MS, 3)]
    return Trace(ev, 2, fit.SPANS)


def _run(trace, cfg, geometry):
    return harness.Run(trace=trace, steps=2, window_s=0.1, step_ms=[],
                       setup_s=1.0, peak_bytes=None, cfg=cfg, inputs={},
                       geometry=geometry)


GEOMETRY = [{"newton_iterations": 100, "contact_capacity": 28000,
             "occupied_cells": 2000, "cell_capacity": 16},
            {"newton_iterations": 110, "contact_capacity": 28000,
             "occupied_cells": 2000, "cell_capacity": 16}]


def test_readers_of_the_contact_step(monkeypatch):
    cfg = config()
    S = profiling.Span
    monkeypatch.setattr(profiling, "spans", lambda: [
        S(1, None, "physics.simplicits.step", 1, 9 * MS, 40 * MS),
        S(2, 1, "physics.simplicits.detect", 1, 9 * MS, 12 * MS)])
    monkeypatch.setattr(profiling, "counters",
                        lambda: {CONTACTS: 30_000})
    run = _run(_trace(), cfg, GEOMETRY)
    read = {n: harness.reader(n)(run) for n in
            ("contact_step_ms", "contact_detect_ms", "contact_solve_ms",
             "contact_pair_share", "contact_step_roofline")}
    # 12 device ms launched in the step span over 2 frames, 2 of them in
    # detection's; the two factorisations 4 ms
    assert read["contact_step_ms"] == pytest.approx(6.0)
    assert read["contact_detect_ms"] == pytest.approx(2.0)
    assert read["contact_solve_ms"] == pytest.approx(2.0)
    assert read["contact_pair_share"] == pytest.approx(
        100 * 30_000 / (2 * 28_000))
    assert read["contact_step_roofline"] == pytest.approx(
        100 * roof.bound_ms(cfg, 15_000, 5, 2000, 16) / 6.0)


def test_readers_without_the_port_record(monkeypatch):
    """A port that keeps no detect span or contact counter (the tree before
    it did) and a run without a trace read None, and nothing raises."""
    cfg = config()
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    run = _run(_trace(), cfg, GEOMETRY)
    for name in ("contact_step_ms", "contact_detect_ms",
                 "contact_pair_share", "contact_step_roofline"):
        assert harness.reader(name)(run) is None, name
    assert harness.reader("contact_solve_ms")(run) == pytest.approx(2.0)
    monkeypatch.delattr(profiling, "spans")
    for name in ("contact_step_ms", "contact_detect_ms",
                 "contact_pair_share", "contact_step_roofline",
                 "contact_solve_ms"):
        assert harness.reader(name)(_run(None, cfg, [])) is None


def test_contact_reference_loads_without_the_port():
    code = ("import sys; import portbench.reference.simplicits_contact_fit, "
            "portbench.roofline.simplicits_contact; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('kaolin_tpu_torch', 'kaolin_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_control_is_not_correct_on_the_card(card):
    cfg = config()
    for seed in (SEED, SEED + 1):
        inputs = fit.make_inputs(cfg, MIX, seed, card)
        want = ref_fit.run(cfg, inputs, cfg["checked_steps"])
        control = ref_fit.run(cfg, inputs, cfg["checked_steps"], tf32=True)
        correct, rows = judge(ref_fit.numbers(control, want), cfg["limits"])
        assert not correct, rows


def test_late_fault_is_not_correct_on_the_card(card):
    """No friction from frame 40 on, put in the program's place on the
    cell's scene: the settling stack's frames alone fail the limits."""
    cfg = config()
    inputs = fit.make_inputs(cfg, MIX, SEED, card)
    want = ref_fit.run(cfg, inputs, cfg["checked_steps"])
    bad = ref_fit.run(cfg, inputs, cfg["checked_steps"],
                      fault="friction_0_from_40")
    correct, rows = judge(ref_fit.numbers(bad, want), cfg["limits"])
    assert not correct, rows


@pytest.mark.parametrize("trace", (False, True))
def test_short_run_is_correct_on_the_card(card, trace):
    bench = harness.benchmark()
    out = harness.run_cell(CELL, SEED + 3, 4.0, trace, card, bench=bench)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    wanted = {m["name"] for m in harness.metrics_of(bench, CELL, trace)}
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"]["contact_step_roofline"]["value"] < 100
    assert set(out["metrics"]) == wanted
