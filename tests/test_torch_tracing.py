"""The port's own record (``kaolin_tpu_torch.utils.profiling``) on the CPU:
nothing while the profiler is off; while it is on, the DIB-R path's spans
nested as the layers call each other, on the profiler's clock, each
backward span holding its own layer's autograd nodes and no other's; a
session per profiler run; the kernels' launch counters in one registry."""

import json
import re
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

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
