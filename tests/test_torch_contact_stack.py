"""Simplicits contact on a stack of soft cubes, the port against the plain
reference of the benchmark (``portbench/reference/simplicits_contact.py``)
on the CPU, and the contact layer's tracing.

The scene is ``portbench``'s ``simplicits_stack10k`` (``bench.py``'s
``collision_10k``) at a CPU test's size and the cell's density of points
(``small``): 2 cubes of 80 points, 4 handles (sin weights, the QR), one
above the other, over a kinematic plate. Their B are nearly singular
(ε₃₂ cond(B)² past ``simulation.CONTACT_ROUNDING_LIMIT``), so the scene
takes the contact terms in z's own basis.

The card's case (skipped here) holds the split detection and Newton graphs
to the eager step bit for bit over 60 frames of the full scene.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kaolin_tpu_torch.physics.common import Collision
from kaolin_tpu_torch.physics.simplicits import simulation
from kaolin_tpu_torch.utils import profiling
from portbench import harness, traffic
from portbench.fits import simplicits_contact as fit
from portbench.reference import simplicits_contact_fit as ref_fit
from tests.torch_parity import load_example
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

SEED = 2147483999
FRAMES = 30
# the cell's limits on each frame's gap over its float32 rounding spread
# (``portbench/reference/simplicits_contact_fit.py``), set from the card's
# readings
LIMITS = harness.cell(harness.benchmark(), "stack10k.e100")[2]["limits"]


def small():
    """The cell's configuration at the CPU's size, at the cell's density of
    points: 2 cubes of side 0.2 and 80 points, 4 handles, one 5 cm over the
    other, over an 8 x 8 plate of side 0.4 that they reach after 9 frames."""
    cfg = harness.cell(harness.benchmark(), "stack10k.e100")[2]
    cfg.update(cubes=2, ring_size=1, ring_radius=0.0, ring_base=-0.3,
               ring_step=0.25, cube_side=0.2, samples=80, handles=4,
               plate_points=64, plate_extent=0.2, checked_steps=FRAMES)
    return cfg


def scene(cfg=None, seed=SEED, device="cpu"):
    cfg = small() if cfg is None else cfg
    inputs = fit.make_inputs(cfg, traffic.load("stack_e100"), seed, device)
    return fit.build(cfg, inputs, device), inputs


@pytest.fixture(scope="module")
def checked():
    """The small scene's first frames, the reference and the numbers."""
    cfg = small()
    state, inputs = scene(cfg)
    record = fit.first_steps(state, FRAMES)
    ref = ref_fit.run(cfg, inputs, FRAMES)
    return {"cfg": cfg, "state": state, "inputs": inputs, "record": record,
            "ref": ref, "numbers": ref_fit.numbers(record, ref),
            "details": ref_fit.details(record, ref)}


def test_stack_takes_contact_terms_in_z_basis(checked):
    """The stack's cubes are past the limit and are re-based, so that
    their B keeps its Kronecker form; the demo scene of the JAX parity
    tests is not, and keeps the raw basis and the rotation."""
    sc = checked["state"]["scene"]
    cubes = [o for o in sc.sim_obj_dict.values() if not o.is_kinematic]
    assert sc._contact_in_z()
    assert min(o.contact_rounding() for o in cubes) \
        > simulation.CONTACT_ROUNDING_LIMIT
    for o in cubes:
        # B K = (A K₄) ⊗ I₃: a point's three rows are its factors, shifted
        rows = o.B_dense.reshape(o.num_qp, 3, -1)
        h4 = o.contact_factors.shape[1]
        lay = rows.reshape(o.num_qp, 3, h4 // 4, 3, 4)
        for r in range(3):
            torch.testing.assert_close(
                lay[:, r, :, r, :].reshape(o.num_qp, h4),
                o.contact_factors, rtol=0, atol=1e-6)
    demo = load_example("torch_collision_stack").demo_scene(
        "cpu", 3, num_qp=48, kinematic_qp=25, max_contact_pairs=512)
    assert not demo._contact_in_z()
    assert demo.get_object(0).contact_factors is None


def test_eager_step_agrees_with_the_reference(checked):
    """Each frame's step against the reference's from the same start, its
    gap over the frame's float32 rounding spread, the median over the 30
    frames (every one of them has contact: the cubes start within reach),
    within the cell's limits (``LIMITS``). Both kinds of contact occur."""
    got = checked["numbers"]
    for name, limit in LIMITS.items():
        assert got[name] <= limit, got
    d = checked["details"]
    assert sum(c > 0 for c in d["cube_pairs_by_frame"]) == FRAMES
    assert sum(c > 0 for c in d["plate_pairs_by_frame"]) >= 10


def test_planted_fault_is_not_correct(checked):
    """The reference with its contact stiffness halved, put in the
    program's place, fails the check's limits by far."""
    c = checked
    bad = ref_fit.run(c["cfg"], c["inputs"], FRAMES, fault="stiffness_half")
    got = ref_fit.numbers(bad, c["ref"])
    assert got["pts"] > 10 * LIMITS["pts"], got
    assert got["height"] > 10 * LIMITS["height"], got


def test_reset_is_held_to_the_reference():
    """Where the traffic resets the scene, the check steps the reference
    from rest, whatever start the program kept: with the cubes starting
    out of reach and 20-frame episodes, the frames after the reset read as
    the first ones, and a scene whose reset does nothing fails ``free``,
    the frames without contact, by far."""
    cfg = dict(small(), ring_step=0.3)
    mix = {"episode_frames": 20}
    inputs = fit.make_inputs(cfg, mix, SEED, "cpu")
    ref = ref_fit.run(cfg, inputs, FRAMES)
    state = fit.build(cfg, inputs, "cpu")
    got = ref_fit.numbers(fit.first_steps(state, FRAMES), ref)
    for name, limit in LIMITS.items():
        assert got[name] <= limit, got
    det = ref_fit.details(fit.first_steps(fit.build(cfg, inputs, "cpu"),
                                          FRAMES), ref)
    pairs = [c + p for c, p in zip(det["cube_pairs_by_frame"],
                                   det["plate_pairs_by_frame"])]
    assert pairs[0] == 0 and pairs[20:30] == pairs[:10]
    broken = fit.build(cfg, inputs, "cpu")
    broken["scene"].reset_scene = lambda: None
    bad = ref_fit.numbers(fit.first_steps(broken, FRAMES), ref)
    assert bad["free"] > 100 * LIMITS["free"], bad


def _counter():
    key = ((simulation.CONTACTS,), torch.device("cpu"))
    block = profiling._device_blocks.get(key)
    return None if block is None else int(block[0])


def _between_sessions():
    with profiling.span("between"):
        pass


def test_contact_counter_counts_live_pairs():
    """While the profiler runs, ``physics.collision.contacts`` adds each
    step's live pairs: the pairs ``collision_diagnostics`` finds at the
    step's start (none overflow); detection runs in its own span inside
    the step's. With the profiler off the counter is not touched."""
    state, _ = scene()
    sc = state["scene"]
    want = 0
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            want += int(sc.collision_diagnostics()["num_pairs"])
            sc.run_sim_step()
    assert want > 0
    assert profiling.counters()[simulation.CONTACTS] == want
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    detect = [r for r in records if r.name == simulation.DETECT_SPAN]
    assert len(detect) == 3
    assert all(by_id[r.parent].name == "physics.simplicits.step"
               for r in detect)
    before = _counter()
    sc.run_sim_step()
    assert _counter() == before


class _Replayed:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    function."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_contact_replays_count_the_fixed_trip():
    """The contact step on its graph path, the graphs' functions run by
    stand-ins: a detection graph and a Newton graph a step, in their own
    spans, ``max_newton_steps`` iterations counted a replay, the live pairs
    counted once a step, and z and ż bit for bit the eager step's."""
    state, _ = scene()
    eager = scene()[0]["scene"]
    sc = state["scene"]
    sc.use_cuda_graphs = True
    graphs = []

    def record(fns):
        for fn in fns:
            fn()
        graphs.append([_Replayed(fn) for fn in fns])
        return graphs[-1]

    sc._record_graphs = record
    counts = profiling.counters()
    before = counts[simulation.NEWTON_ITERATIONS]
    want = 0
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            want += int(sc.collision_diagnostics()["num_pairs"])
            sc.run_sim_step()
    counts = profiling.counters()
    for _ in range(3):
        eager.run_sim_step()
    assert len(graphs) == 1 and len(graphs[0]) == 2
    assert counts[simulation.NEWTON_ITERATIONS] - before \
        == 3 * sc.max_newton_steps
    assert counts[simulation.CONTACTS] == want
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    assert sum(r.name == simulation.DETECT_SPAN
               and by_id[r.parent].name == "physics.simplicits.step"
               for r in records) == 3
    # a replay of the Newton graph and a read of the LU count a step
    assert sum(r.name == "physics.simplicits.replay" for r in records) == 6
    assert torch.equal(sc.sim_z, eager.sim_z)
    assert torch.equal(sc.sim_z_dot, eager.sim_z_dot)


def test_reset_keeps_unread_overflow_bits():
    """An overflow in frame 98 of a 100-frame episode, after the check of
    frame 96: the reset keeps its bit, and the check of the next episode's
    frame 16 reports it and resizes; the flags read no host value before
    it."""
    sc = load_example("torch_collision_stack").demo_scene(
        "cpu", 3, num_qp=48, kinematic_qp=25, max_contact_pairs=512,
        broad_phase="dense")
    col = sc.force_dict["collision"]["object"]
    for frame in range(1, 101):
        if frame == 98:
            col.max_contacts = 1
            sc._invalidate()
        sc.run_sim_step()
        if frame == 98:
            col.max_contacts = 512
            sc._invalidate()
            assert int(sc.collision_overflow_flags()) \
                & Collision.FLAG_CONTACTS_OVERFLOW
    assert sc.collision_resizes == 0
    sc.reset_scene()
    assert int(sc.collision_overflow_flags()) \
        & Collision.FLAG_CONTACTS_OVERFLOW
    for _ in range(15):
        sc.run_sim_step()
    assert sc.collision_resizes == 0
    sc.run_sim_step()
    assert sc.collision_resizes == 1
    assert col.max_contacts == 1024
    assert int(sc.collision_overflow_flags()) == 0


def test_split_graphs_match_the_eager_step_on_the_card():
    """On the card, the cell's full scene: the detection and Newton graphs
    against the eager step, z and ż bit for bit in each of 60 frames, a
    reset after the 40th."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = harness.cell(harness.benchmark(), "stack10k.e100")[2]
    graph = scene(cfg, device="cuda")[0]["scene"]
    cfg_eager = dict(cfg, use_cuda_graphs=False)
    eager = scene(cfg_eager, device="cuda")[0]["scene"]
    assert graph.use_cuda_graphs and not eager.use_cuda_graphs
    for frame in range(1, 61):
        graph.run_sim_step()
        eager.run_sim_step()
        for x, y in ((graph.sim_z, eager.sim_z),
                     (graph.sim_z_dot, eager.sim_z_dot)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
                frame
        if frame == 40:
            graph.reset_scene()
            eager.reset_scene()
    assert graph.graph_steps_rerun == 0
    assert int(graph.collision_overflow_flags()) == 0
