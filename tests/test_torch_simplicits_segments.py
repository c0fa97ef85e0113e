"""The Simplicits scene's graph path without the LU, on the CPU: its three
captured functions (``start``: the set-up and two Newton iterations;
``iterate``: one more; ``finish``: the state written) run eagerly where the
card would replay them, under ``SimplicitsScene._replay``'s own control
flow, which replays ``iterate`` while the device's flags say neither
converged nor failed.

The drop scene of ``tests/test_torch_simplicits_scene.py`` at its size
(256 points, 9 handles, dt 0.03, 5 line-search steps) with kaolin's 5
Newton iterations, so that steps take 2 to 5 of them. Its z, z_prev and
z_dot are held bit for bit against Newton's fixed trip (the graph's loop
before) and the early-exit loop, and the iterations run against the
early-exit loop's.
"""

import contextlib
import importlib.util

import torch

from kaolin_tpu_torch.physics.common.optimization import newtons_method
from kaolin_tpu_torch.physics.simplicits import simulation
from kaolin_tpu_torch.utils import profiling
from tests.torch_parity import ROOT
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

FRAMES = 50
NEWTON_STEPS = 5


def _load_drop():
    path = f"{ROOT}/examples/torch_simplicits_drop.py"
    spec = importlib.util.spec_from_file_location("torch_simplicits_drop",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


drop = _load_drop()


class _Replayed:
    """A CUDA graph's stand-in: a replay runs the captured function."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _record(fns):
    """``_record_graphs``'s stand-in: each function's warm-up, then a
    stand-in a graph."""
    for fn in fns:
        fn()
    return [_Replayed(fn) for fn in fns]


def _scene(segmented=False, **kw):
    """The drop scene; ``segmented``: on the graph path without the LU,
    its graphs replayed by :class:`_Replayed`."""
    scene = drop.make_scene(drop.graft_points(), "cpu", 0.03, NEWTON_STEPS,
                            5, **kw)
    if segmented:
        scene.use_cuda_graphs = True
        scene._record_graphs = _record
    return scene


def _iterations():
    return profiling.counters()[simulation.NEWTON_ITERATIONS]


def _same(a, b):
    """z, z_prev and z_dot of two scenes equal bit for bit."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in ((a.sim_z, b.sim_z), (a.sim_z_prev, b.sim_z_prev),
                            (a.sim_z_dot, b.sim_z_dot)))


@contextlib.contextmanager
def _cholesky_fails_at(call):
    """``torch.linalg.cholesky_ex`` reporting its ``call``-th factorization
    from here (from 1) failed (info 1); the others as they are."""
    real, calls = torch.linalg.cholesky_ex, [0]

    def counted(a, *args, **kwargs):
        factor, info = real(a, *args, **kwargs)
        calls[0] += 1
        return factor, (torch.ones_like(info) if calls[0] == call else info)

    torch.linalg.cholesky_ex = counted
    try:
        yield calls
    finally:
        torch.linalg.cholesky_ex = real


def test_segments_equal_fixed_trip_and_early_exit():
    """Over 50 frames through floor contact: z, z_prev and z_dot after every
    frame bit for bit the fixed trip's and the early-exit loop's, and the
    graphs' iterations each frame the early-exit loop's."""
    seg, fixed, early = (_scene(segmented=True), _scene(differentiable=True),
                         _scene())
    ran, counted = [], []
    for _ in range(FRAMES):
        start = _iterations()
        seg.run_sim_step()
        counted.append(_iterations() - start)
        start = newtons_method.iterations
        early.run_sim_step()
        ran.append(newtons_method.iterations - start)
        fixed.run_sim_step()
        assert _same(seg, fixed) and _same(seg, early)
    assert counted == ran
    assert min(ran) == 2 and max(ran) == NEWTON_STEPS
    assert seg.graph_steps_rerun == 0
    assert float(seg.get_object_deformed_pts(0)[:, 1].min()) < -1.0


def test_segments_stop_at_the_most_iterations():
    """With ``conv_tol`` 0 no step converges: every frame replays
    ``iterate`` until ``max_newton_steps`` iterations have run, and still
    equals the fixed trip bit for bit."""
    seg = _scene(segmented=True, conv_tol=0.0)
    fixed = _scene(differentiable=True, conv_tol=0.0)
    for _ in range(10):
        start = _iterations()
        seg.run_sim_step()
        assert _iterations() - start == NEWTON_STEPS
        fixed.run_sim_step()
        assert _same(seg, fixed)


def test_cholesky_failure_in_iteration_three_runs_the_step_again():
    """A Cholesky failure in a frame's third iteration (the first
    ``iterate``) stops the frame's replays before ``finish``, and the step
    runs again eagerly from the state it started from: the eager step's z,
    and the next frames the eager steps'."""
    seg, early = _scene(segmented=True, conv_tol=0.0), _scene(conv_tol=0.0)
    for _ in range(3):
        seg.run_sim_step()
        early.run_sim_step()
    start = _iterations()
    with _cholesky_fails_at(3) as calls:
        seg.run_sim_step()
    assert _iterations() - start == 3
    # three in the graphs, then the eager step's five
    assert calls[0] == 3 + NEWTON_STEPS
    assert seg.graph_steps_rerun == 1
    early.run_sim_step()
    assert _same(seg, early)
    for _ in range(2):
        seg.run_sim_step()
        early.run_sim_step()
        assert _same(seg, early)
    assert seg.graph_steps_rerun == 1


def test_segments_hold_a_kinematic_object():
    """Two objects, the second kinematic and moved mid-run: the graphs'
    iteration runs over the dynamic DOFs with the kinematic ones as set,
    bit for bit the early-exit loop's."""
    def scene(**kw):
        a, b = drop.graft_points(64, 4), drop.graft_points(48, 3)
        lift = torch.eye(4)
        lift[1, 3] = -0.6
        out = simulation.SimplicitsScene(
            timestep=0.03, max_newton_steps=NEWTON_STEPS, max_ls_steps=5,
            device="cpu", **kw)
        for p, kin, init in ((a, False, None), (b, True, lift)):
            out.add_object(simulation.SkinnedPhysicsPoints(
                pts=p["pts"] * (0.5 if kin else 1.0), yms=1e4, prs=0.45,
                rhos=500.0, appx_vol=1.0, skinning_weights=p["w"],
                dwdx=p["dwdx"]), is_kinematic=kin, init_transform=init)
        out.set_scene_gravity((0.0, 9.8, 0.0))
        out.set_scene_floor(floor_height=-1.0)
        return out

    seg, early = scene(), scene()
    seg.use_cuda_graphs = True
    seg._record_graphs = _record
    move = torch.eye(4)
    move[0, 3] = 0.2
    for frame in range(20):
        if frame == 10:
            for s in (seg, early):
                s.set_kinematic_object_transform(1, move)
        seg.run_sim_step()
        early.run_sim_step()
        assert _same(seg, early)
    assert torch.equal(seg.sim_z[seg.obj_z_slices[1]], seg.get_object(1).z)
