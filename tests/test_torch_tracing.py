"""The port's own record (``kaolin_tpu_torch.utils.profiling``) on the CPU:
nothing while the profiler is off; while it is on, the DIB-R path's spans
nested as the layers call each other, on the profiler's clock, each
backward span holding its own layer's autograd nodes and no other's; a
session per profiler run; the kernels' launch counters in one registry;
the Simplicits step's spans and graph counters, and a step the profiler
leaves bit for bit as it was."""

import contextlib
import json
import re
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kaolin_tpu_torch.physics.common.optimization import newtons_method
from kaolin_tpu_torch.physics.simplicits import (
    SimplicitsScene,
    SkinnedPhysicsPoints,
    simulation,
)
from kaolin_tpu_torch.render.mesh import (
    cuda_rasterize,
    cuda_soft_mask,
    dibr_rasterization,
    texture_mapping,
)
from kaolin_tpu_torch.render.spc import cuda_raster
from kaolin_tpu_torch.utils import cuda_gather, profiling
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

B, F, RES, TEX = 2, 12, 24, 8
# each span, with its parent (None: at the top)
NESTING = {
    "render.mesh.dibr_rasterization": None,
    "render.mesh.rasterize.search": "render.mesh.dibr_rasterization",
    "render.mesh.rasterize.interpolate": "render.mesh.dibr_rasterization",
    "render.mesh.rasterize.interpolate.backward":
        "render.mesh.rasterize.interpolate",
    "render.mesh.dibr_soft_mask": "render.mesh.dibr_rasterization",
    "render.mesh.dibr_soft_mask.backward": "render.mesh.dibr_soft_mask",
    "render.mesh.texture_mapping": None,
    "render.mesh.texture_mapping.backward": "render.mesh.texture_mapping",
}
NODE = re.compile(r"^\w+Backward\d*$")


def _scene():
    g = torch.Generator().manual_seed(3)
    return {"fvi": (torch.rand(B, F, 3, 2, generator=g) * 1.6 - 0.8)
            .requires_grad_(True),
            "fvz": -1.0 - torch.rand(B, F, 3, generator=g),
            "uvs": torch.rand(B, F, 3, 2, generator=g),
            "nz": torch.ones(B, F),
            "tex": torch.rand(3, TEX, TEX, generator=g).requires_grad_(True)}


def _step(s, keep=None):
    """The fit's step on a small scene: render, texture, loss, backward;
    ``keep`` (a dict) gets the texture layer's inputs and output."""
    (uv, mask), soft, _ = dibr_rasterization(
        RES, RES, s["fvz"], s["fvi"], [s["uvs"], torch.ones_like(
            s["uvs"][..., :1])], s["nz"])
    tex = s["tex"][None].expand(B, -1, -1, -1)
    sampled = texture_mapping(uv, tex, mode="bilinear")
    if keep is not None:
        keep.update(uv=uv, tex=tex, out=sampled)
    loss = (sampled * mask).abs().mean() + soft.mean()
    loss.backward()


def _between_sessions():
    """An instrumented call while the profiler is off: the next call that
    finds it on starts a session."""
    with profiling.span("between"):
        pass


def _traced_step(s, keep=None):
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(s, keep)
    return profiling.spans(), prof.profiler.kineto_results.events()


def _inside(events, span):
    return [e for e in events if span.start_ns <= e.start_ns()
            and e.end_ns() <= span.end_ns]


def test_profiler_off_leaves_no_record(monkeypatch):
    """While the profiler is off, no span site calls ``record_function``,
    reads the clock or puts a hook on the graph, and the record stays as
    the last session left it."""
    def refuse(*args, **kwargs):
        raise AssertionError("called while the profiler is off")

    s = _scene()
    _step(s)
    before = profiling.spans()
    monkeypatch.setattr(profiling, "_record_function", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "_BackwardSpan", refuse)
    monkeypatch.setattr(profiling, "_entry_nodes", refuse)
    _step(s)
    assert profiling.spans() == before


def test_spans_nest_and_share_the_profiler_clock():
    """Every span the table names, once, under its parent; each encloses
    the profiler's own range of the same name (``start_ns``/``end_ns`` of
    its events), so the record and the trace share one clock."""
    records, events = _traced_step(_scene())
    by_id = {r.id: r for r in records}
    assert sorted(r.name for r in records) == sorted(NESTING)
    for r in records:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent == NESTING[r.name], r
        ranges = [e for e in events if e.name() == r.name]
        assert len(ranges) == 1, r.name
        assert r.start_ns <= ranges[0].start_ns() <= ranges[0].end_ns() \
            <= r.end_ns, r.name
    forward = by_id[next(r.id for r in records
                         if r.name == "render.mesh.dibr_rasterization")]
    for r in records:
        if r.parent == forward.id:     # the wrapper's parts lie inside it
            assert forward.start_ns <= r.start_ns <= r.end_ns \
                <= forward.end_ns
    own = profiling.self_ns(records)
    assert 0 <= own[forward.id] < forward.end_ns - forward.start_ns


def _layer_nodes(root, stop):
    """Names of the nodes reachable from ``root`` without entering a node
    for which ``stop`` holds."""
    names, seen, todo = [], {root}, [root]
    while todo:
        node = todo.pop()
        names.append(type(node).__name__)
        for nxt, _ in node.next_functions:
            if nxt is not None and nxt not in seen and not stop(nxt):
                seen.add(nxt)
                todo.append(nxt)
    return Counter(names)


def test_texture_backward_span_holds_the_texture_nodes_only():
    """``render.mesh.texture_mapping.backward`` holds exactly the nodes
    ``texture_mapping`` made (its four ``GatherBackward0`` among them),
    down to the texture leaf that the caller expanded and the layer reads
    once: not the caller's expand, which no gradient passes, not the
    rasterizer's split and not the soft mask's backward."""
    keep = {}
    s = _scene()
    records, events = _traced_step(s, keep)
    span, = [r for r in records
             if r.name == "render.mesh.texture_mapping.backward"]
    ends = {keep["uv"].grad_fn, keep["tex"].grad_fn}
    want = _layer_nodes(keep["out"].grad_fn, lambda n: n in ends or getattr(
        n, "variable", None) is s["tex"])
    got = Counter(e.name() for e in _inside(events, span)
                  if NODE.match(e.name()))
    assert got == want
    assert got["GatherBackward0"] == 4


def test_regather_backward_span_holds_the_regather_nodes_only():
    """``render.mesh.rasterize.interpolate.backward`` holds the one
    ``GatherBackward0`` of the re-gather, and of the step's five (four
    the texture's) no other; nothing of the soft mask or the texture."""
    records, events = _traced_step(_scene())
    span, = [r for r in records
             if r.name == "render.mesh.rasterize.interpolate.backward"]
    tex, = [r for r in records
            if r.name == "render.mesh.texture_mapping.backward"]
    got = Counter(e.name() for e in _inside(events, span)
                  if NODE.match(e.name()))
    assert got["GatherBackward0"] == 1
    assert got["CatBackward0"] == 1          # the (B, F, 6 + 3D) table
    assert not {"_SoftMaskBackward", "SplitWithSizesBackward0",
                "ExpandBackward0"} & set(got)
    gathers = [e for e in events if e.name() == "GatherBackward0"]
    assert len(gathers) == 5
    assert len(_inside(gathers, span)) + len(_inside(gathers, tex)) == 5


def test_regather_backward_span_holds_the_kernels_node(monkeypatch):
    """On the card the re-gather is one autograd node, ``_Regather``'s.
    With its kernels swapped for the plain version and the kernels' rule
    (``chip_smoke.regather_bwd_rule``) and the card's route taken for the
    re-gather alone, ``render.mesh.rasterize.interpolate.backward`` holds
    that node and the one backward call, and no node of another layer."""
    from chip_smoke import regather_bwd_rule
    from kaolin_tpu_torch.render.mesh import cuda_regather, rasterization

    calls = []

    def fwd(face_idx, scaled, features, multiplier, eps):
        with torch.no_grad():
            return rasterization.interpolate_at_winners_plain(
                face_idx, scaled, features, multiplier, eps)

    def bwd(*args):
        calls.append(profiling._clock())
        return regather_bwd_rule(*args)

    monkeypatch.setattr(cuda_regather, "regather_fwd_cuda", fwd)
    monkeypatch.setattr(cuda_regather, "regather_bwd_cuda", bwd)
    # the re-gather's (B, F, 3, 2) vertices take the card's route; the
    # search's (B, F, 3) depths stay on the plain one
    monkeypatch.setattr(rasterization, "is_cuda", lambda t: t.dim() == 4)
    records, events = _traced_step(_scene())
    span, = [r for r in records
             if r.name == "render.mesh.rasterize.interpolate.backward"]
    got = Counter(e.name() for e in _inside(events, span)
                  if NODE.match(e.name()))
    assert got == Counter({"_RegatherBackward": 1})
    assert len(calls) == 1 and span.start_ns <= calls[0] <= span.end_ns


def test_a_second_session_starts_afresh(tmp_path):
    """A profiler run after a call that found it off starts with an empty
    buffer; :func:`profiling.trace` starts one of its own and writes its
    spans, with self times, and counters to ``spans.json``."""
    s = _scene()
    first, _ = _traced_step(s)
    assert first
    with torch.no_grad():       # found off: the next run is a new session
        texture_mapping(torch.rand(1, 4, 2), s["tex"][None])
    with profile(activities=[ProfilerActivity.CPU]):
        texture_mapping(torch.rand(1, 4, 2), s["tex"][None])
    assert [r.name for r in profiling.spans()] \
        == ["render.mesh.texture_mapping"]
    with profiling.trace("two", str(tmp_path)):
        with profiling.span("outer"):
            texture_mapping(torch.rand(1, 4, 2), s["tex"][None])
    saved = json.loads((tmp_path / "two" / "spans.json").read_text())
    assert [r["name"] for r in saved["spans"]] \
        == ["render.mesh.texture_mapping", "outer"]
    inner, outer = saved["spans"]
    assert inner["parent"] == outer["id"]
    assert outer["self_ns"] == (outer["end_ns"] - outer["start_ns"]
                                - (inner["end_ns"] - inner["start_ns"]))
    assert saved["counters"]["utils.profiling.spans_dropped"] == 0


def test_self_time_leaves_out_children_and_not_backward_spans():
    S = profiling.Span
    records = [S(2, 1, "child", 7, 20, 50), S(1, None, "top", 7, 0, 100),
               S(3, 1, "top.backward", 8, 150, 190),
               S(4, 1, "other thread", 9, 10, 30)]
    assert profiling.self_ns(records) == {1: 70, 2: 30, 3: 40, 4: 20}


def test_launch_counters_are_one_registry_at_zero_on_the_cpu():
    """The kernels' launch counters live in the registry, listed from
    import, and the CPU's plain paths launch nothing; the pair counters are
    the card's alone."""
    records, _ = _traced_step(_scene())
    assert records
    counts = profiling.counters()
    names = (cuda_rasterize.LAUNCHES, cuda_soft_mask.FWD_LAUNCHES,
             cuda_soft_mask.FWD_WITH_FACE_IDX, cuda_soft_mask.BWD_LAUNCHES,
             cuda_raster.RASTER_LAUNCHES, cuda_raster.UNTILE_LAUNCHES,
             cuda_gather.SMEM_LAUNCHES, cuda_gather.L2_LAUNCHES)
    assert {n: counts[n] for n in names} == dict.fromkeys(names, 0)
    assert not set(cuda_rasterize.PAIRS) & set(counts)
    for fn in (cuda_rasterize.rasterize_search_cuda,
               cuda_soft_mask.soft_mask_fwd_cuda,
               cuda_soft_mask.soft_mask_bwd_cuda,
               cuda_raster.raster_tiles_cuda, cuda_raster.untile_cuda,
               cuda_gather.table_gather_smem_cuda,
               cuda_gather.table_gather_l2_cuda):
        assert not hasattr(fn, "launches"), fn.__name__


def test_the_buffer_is_bounded(monkeypatch):
    """Past ``MAX_SPANS`` a session counts its spans and keeps none."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.counters()["utils.profiling.spans_dropped"] == 2


# -- the Simplicits step's spans and counters --------------------------------

PHYSICS_NESTING = {
    "physics.simplicits.step": None,
    "physics.newton.assemble": "physics.simplicits.step",
    "physics.newton.solve": "physics.simplicits.step",
    "physics.newton.line_search": "physics.simplicits.step",
    "physics.simplicits.deformed_pts": None,
}
GRAPH_COUNTERS = (simulation.CAPTURES, simulation.GRAPH_REPLAYS,
                  simulation.NEWTON_ITERATIONS)


def _drop_scene(device="cpu", **kwargs):
    """A 48-point, 4-handle box over a floor it reaches in a few steps."""
    g = torch.Generator().manual_seed(5)
    pts = torch.rand(48, 3, generator=g) - 0.5
    freqs = torch.randn(3, 3, generator=g)
    arg = pts @ freqs
    w = torch.cat([torch.sin(arg), torch.ones(48, 1)], dim=1)
    dwdx = torch.zeros(48, 4, 3)
    dwdx[:, :3] = torch.cos(arg)[:, :, None] * freqs.T[None]
    scene = SimplicitsScene(timestep=0.05, max_newton_steps=3,
                            max_ls_steps=5, device=device, **kwargs)
    scene.add_object(SkinnedPhysicsPoints(
        pts=pts, yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
        skinning_weights=w, dwdx=dwdx))
    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-0.6, floor_axis=1,
                          floor_penalty=1e4)
    return scene


def _counts():
    counts = profiling.counters()
    return {n: counts[n] for n in GRAPH_COUNTERS}


def _delta(before):
    return {n: v - before[n] for n, v in _counts().items()}


def test_physics_spans_nest_on_the_eager_path():
    """An eager step holds each Newton iteration's assemble, solve and line
    search, in that order; ``run_sim_steps`` is one step span; the
    deformed points' span stands alone."""
    scene = _drop_scene()
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        scene.run_sim_step()
        scene.run_sim_steps(2)
        scene.get_object_deformed_pts(0)
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    assert {r.name for r in records} == set(PHYSICS_NESTING)
    for r in records:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent == PHYSICS_NESTING[r.name], r
        if parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    steps = [r for r in records if r.name == "physics.simplicits.step"]
    assert len(steps) == 2
    for s in steps:
        inner = sorted((r for r in records if r.parent == s.id),
                       key=lambda r: r.start_ns)
        names = [r.name.rsplit(".", 1)[1] for r in inner]
        assert names and names == ["assemble", "solve", "line_search"] \
            * (len(names) // 3)
    # the three steps ran every iteration of the early-exit loop
    assert 3 <= sum(r.name == "physics.newton.solve" for r in records) <= 9


@contextlib.contextmanager
def _cholesky_fails():
    """``torch.linalg.cholesky_ex`` reporting every factorization failed
    (info 1), as an indefinite Hessian's would be."""
    real = torch.linalg.cholesky_ex

    def failing(a, *args, **kwargs):
        factor, info = real(a, *args, **kwargs)
        return factor, torch.ones_like(info)

    torch.linalg.cholesky_ex = failing
    try:
        yield
    finally:
        torch.linalg.cholesky_ex = real


class _Replayed:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    function, and the replays numbered in ``fail_on`` (from 1) run it with
    every Cholesky failing."""

    def __init__(self, fn, fail_on=()):
        self.fn, self.fail_on, self.replays = fn, set(fail_on), 0

    def replay(self):
        self.replays += 1
        with (_cholesky_fails() if self.replays in self.fail_on
              else contextlib.nullcontext()):
            self.fn()


def _graph_scene(fail_on, with_lu=False):
    """The drop scene on its graph path, the graphs' functions run by
    :class:`_Replayed` after their warm-up: the first graph's Cholesky
    fails on the replays in ``fail_on``. ``with_lu``: the graph that takes
    the LU, as contact makes it."""
    scene = _drop_scene()
    scene.use_cuda_graphs = True
    if with_lu:
        scene._graph_takes_lu = lambda: True
    graphs = []

    def record(fns):
        for fn in fns:
            fn()
        graphs.append([_Replayed(fn, fail_on if i == 0 else ())
                       for i, fn in enumerate(fns)])
        return graphs[-1]

    scene._record_graphs = record
    return scene, graphs


def test_graph_counters_count_captures_replays_and_reruns():
    """One capture, a replay a step, the graphs' Newton iterations, and the
    replay whose Cholesky failed run again eagerly inside its own span,
    with Newton's spans; with the LU in the graph, the steps that took it,
    read once a call, and the fixed trip's iterations, all of them a
    replay."""
    scene, graphs = _graph_scene(fail_on={2})
    before = _counts()
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            scene.run_sim_step()
    assert len(graphs) == 1
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    names = Counter(r.name for r in records)
    # two iterations a step before the first read, then one an iterate
    assert _delta(before) == {
        simulation.CAPTURES: 1, simulation.GRAPH_REPLAYS: 4,
        simulation.NEWTON_ITERATIONS: 2 * 4 + names[
            "physics.simplicits.iterate"]}
    assert (scene.graph_steps_rerun, scene.graph_steps_lu) == (1, 0)
    assert names["physics.simplicits.step"] == 4
    assert names["physics.simplicits.capture"] == 1
    assert names["physics.simplicits.replay"] == 4
    assert names["physics.simplicits.rerun"] == 1
    rerun, = [r for r in records if r.name == "physics.simplicits.rerun"]
    assert by_id[rerun.parent].name == "physics.simplicits.step"
    assert all(by_id[r.parent].name == "physics.simplicits.replay"
               for r in records if r.name == "physics.simplicits.iterate")
    # the capture's warm-up and the stand-in's replays run Newton on the
    # host, under their own spans
    newton = Counter(by_id[r.parent].name for r in records
                     if r.name.startswith("physics.newton."))
    assert newton["physics.simplicits.rerun"] >= 3
    assert newton["physics.simplicits.iterate"] == 3 * names[
        "physics.simplicits.iterate"]
    assert set(newton) == {"physics.simplicits.capture",
                           "physics.simplicits.rerun",
                           "physics.simplicits.replay"} | (
        {"physics.simplicits.iterate"} if names["physics.simplicits.iterate"]
        else set())

    scene, _ = _graph_scene(fail_on={1, 3}, with_lu=True)
    before = _counts()
    scene.run_sim_steps(3)
    assert _delta(before) == {simulation.CAPTURES: 1,
                              simulation.GRAPH_REPLAYS: 3,
                              simulation.NEWTON_ITERATIONS: 3 * 3}
    assert (scene.graph_steps_rerun, scene.graph_steps_lu) == (0, 2)


def test_graph_counters_on_the_card():
    """On the card, the real graphs: one capture, a replay a step, and the
    iterations of the early-exit loop, two at least a step, with its z bit
    for bit; the drop's Cholesky never fails, so no step runs again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _drop_scene("cuda", use_cuda_graphs=True)
    eager = _drop_scene("cuda")
    ran = []

    def eager_steps(n):
        for _ in range(n):
            start = newtons_method.iterations
            eager.run_sim_step()
            ran.append(newtons_method.iterations - start)

    before = _counts()
    for _ in range(5):
        scene.run_sim_step()
        eager_steps(1)
    scene.run_sim_steps(3)
    eager_steps(3)
    assert _delta(before) == {
        simulation.CAPTURES: 1, simulation.GRAPH_REPLAYS: 8,
        simulation.NEWTON_ITERATIONS: sum(max(2, n) for n in ran)}
    assert (scene.graph_steps_rerun, scene.graph_steps_lu) == (0, 0)
    for x, y in ((scene.sim_z, eager.sim_z),
                 (scene.sim_z_dot, eager.sim_z_dot)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_the_profiler_leaves_the_step_as_it_is():
    """Eight steps, through floor contact, with the profiler off and on:
    the same z bit for bit."""
    off, on = _drop_scene(), _drop_scene()
    for _ in range(8):
        off.run_sim_step()
    _between_sessions()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(8):
            on.run_sim_step()
    assert profiling.spans()
    assert float(off.get_object_deformed_pts(0)[:, 1].min()) < -0.6
    assert torch.equal(off.sim_z, on.sim_z)
    assert torch.equal(off.sim_z_dot, on.sim_z_dot)
