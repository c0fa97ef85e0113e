"""The readers of the port's own record (``program_trace.py`` and the four
metrics on it), on a trace and records made up here: which operations a
backward span takes, the idle time inside the wrapper's spans, the pair
share, the window's filter and the None cases; and the pairs a step needs,
against a brute count."""

import pytest
import torch

from kaolin_tpu_torch.utils import profiling
from portbench import harness, program_trace
from portbench.fits import dibr
from portbench.reference import dibr as ref
from portbench.roofline import dibr_pairs
from portbench.tests.conftest import SEED, small
from portbench.tests.test_portbench_trace import Ev
from portbench.trace import WINDOW, Trace

MS = 1_000_000
TEX_BWD = "render.mesh.texture_mapping.backward"
REGATHER_BWD = "render.mesh.rasterize.interpolate.backward"
WRAPPER = "render.mesh.dibr_rasterization"
PAIRS = ("render.mesh.winner.pairs", "render.mesh.soft_mask_fwd.pairs",
         "render.mesh.soft_mask_bwd.pairs")
READERS = ("texture_bwd_ms", "regather_bwd_ms", "dibr_rasterization_idle_ms",
           "dibr_pair_share")


def _trace():
    """A 100-ms window of 2 steps. Device work: 40-50 ms launched at 22 ms,
    50-52 at 27, 5-8 at 2, 96-99 launched at −8 ms (before the window)."""
    ev = [Ev("cpu_annotation", WINDOW, 0, 100 * MS),
          Ev("cuda_runtime", "cudaLaunchKernel", 22 * MS, 23 * MS, 1),
          Ev("cuda_runtime", "cudaLaunchKernel", 27 * MS, 28 * MS, 2),
          Ev("cuda_runtime", "cudaLaunchKernel", 2 * MS, 3 * MS, 3),
          Ev("cuda_runtime", "cudaLaunchKernel", -8 * MS, -7 * MS, 4),
          Ev("gpu_kernel", "_scatter_gather_elementwise_kernel", 40 * MS,
             50 * MS, 1),
          Ev("gpu_kernel", "_scatter_gather_elementwise_kernel", 50 * MS,
             52 * MS, 2),
          Ev("gpu_kernel", "winner_kernel", 5 * MS, 8 * MS, 3),
          Ev("gpu_kernel", "soft_bwd_kernel", 96 * MS, 99 * MS, 4),
          Ev("gpu_annotation", TEX_BWD, 40 * MS, 50 * MS, 0),
          Ev("cpu_annotation", TEX_BWD, 21 * MS, 25 * MS)]
    return Trace(ev, 2, ("backward",))


def _spans():
    """Spans in the window, and one of each name outside it (or across its
    end), which the readers leave out."""
    S = profiling.Span
    return [S(1, None, WRAPPER, 1, 1 * MS, 10 * MS),
            S(2, None, WRAPPER, 1, 30 * MS, 45 * MS),
            S(3, None, WRAPPER, 1, 95 * MS, 105 * MS),
            S(4, None, TEX_BWD, 2, 21 * MS, 25 * MS),
            S(5, None, TEX_BWD, 2, -10 * MS, -5 * MS),
            S(6, None, REGATHER_BWD, 2, 26 * MS, 29 * MS)]


def _run(trace, steps=2, geometry=("start", "end")):
    return harness.Run(trace=trace, steps=steps, window_s=0.1, step_ms=[],
                       setup_s=1.0, peak_bytes=None, cfg={}, inputs={},
                       geometry=list(geometry))


@pytest.fixture
def record(monkeypatch):
    """The port's record, made up: ``counts`` is what ``counters()``
    returns."""
    counts = {n: v for n, v in zip(PAIRS, (500, 300, 200))}
    monkeypatch.setattr(profiling, "spans", _spans)
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    monkeypatch.setattr(dibr_pairs, "needed_per_step",
                        lambda cfg, inputs, geometry: 125.0)
    return counts


def test_readers_of_the_port_record(record):
    read = {n: harness.reader(n)(_run(_trace())) for n in READERS}
    # 10 ms launched inside the texture's backward span, 2 steps
    assert read["texture_bwd_ms"] == pytest.approx(5.0)
    assert read["regather_bwd_ms"] == pytest.approx(1.0)
    # busy 5-8, 40-52, 96-99: idle in 1-10 is 1-5 and 8-10 (6 ms), in
    # 30-45 it is 30-40 (10 ms); the span across the window's end is out
    assert read["dibr_rasterization_idle_ms"] == pytest.approx(8.0)
    # 125 pairs needed a step against (500 + 300 + 200) / 2 visited
    assert read["dibr_pair_share"] == pytest.approx(25.0)


def test_the_window_filter():
    """Only spans wholly inside the window count: the texture span before
    it would otherwise take the kernel launched at −8 ms."""
    run = _run(_trace())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "spans", _spans)
        assert program_trace.spans(run, TEX_BWD) == [(21 * MS, 25 * MS)]
        assert program_trace.spans(run, WRAPPER) == [(1 * MS, 10 * MS),
                                                     (30 * MS, 45 * MS)]
        assert program_trace.spans(run, "render.mesh.absent") is None


def test_none_without_a_trace_or_a_record(record, monkeypatch):
    for n in READERS:
        assert harness.reader(n)(_run(None)) is None, n
    run = _run(_trace())
    for name in PAIRS[1:]:      # a counter missing, or at 0
        del record[name]
        assert harness.reader("dibr_pair_share")(run) is None
    assert harness.reader("dibr_pair_share")(_run(_trace(),
                                                  geometry=())) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    for n in READERS[:3]:
        assert harness.reader(n)(run) is None, n
    # a port without the record (before it kept one) reads None, no error
    monkeypatch.delattr(profiling, "spans")
    for n in READERS:
        assert harness.reader(n)(run) is None, n


def test_no_device_work_reads_none(record):
    """On the CPU a traced run has spans but no device operation."""
    ev = [Ev("cpu_annotation", WINDOW, 0, 100 * MS)]
    run = _run(Trace(ev, 2, ()))
    for n in READERS[:3]:
        assert harness.reader(n)(run) is None, n


def test_needed_pairs_against_a_brute_count():
    """``dibr_pairs.needed`` against every (pixel, face) pair of a small
    cell counted one by one: #1's at valid faces' closed boxes, #2's and
    #3's at uncovered pixels of the enlarged, half-open boxes."""
    cfg = small("texfit.v8")
    mix = harness.cell(harness.benchmark(), "texfit.v8")[3]
    inputs = dibr.make_inputs(cfg, mix, SEED, "cpu")
    state = dibr.build(cfg, inputs, "cpu")
    params = dibr.geometry(state)
    p1, p2 = dibr_pairs.needed(cfg, inputs, params)

    soft, res = cfg["soft_mask"], cfg["res"]
    mult, margin = soft["multiplier"], soft["boxlen"] * soft["multiplier"]
    cams = ref.look_at_matrices(inputs["cam_pos"], inputs["look_at"],
                                inputs["up"])
    proj = ref.projection(inputs["fovy"], torch.float32, cams.device)
    with torch.no_grad():
        v = ref.posed_vertices(inputs["template"], params)
        fvz, fvi, nz = ref.prepare_vertices(v[None], inputs["faces"], proj,
                                            cams)
        fvi = fvi * mult
        ids = ref.winner_search(fvz, fvi, nz >= 0, res, res, mult, 1 << 20)
    px, py = ref.pixel_coords(res, res, mult, torch.float32, "cpu")
    px, py = px[..., None], py[..., None]
    lo, hi = fvi.amin(dim=2), fvi.amax(dim=2)            # (N, F, 2)
    b1 = b2 = 0
    for i in range(fvi.shape[0]):
        closed = ((px >= lo[i, :, 0]) & (px <= hi[i, :, 0])
                  & (py >= lo[i, :, 1]) & (py <= hi[i, :, 1]))
        b1 += int((closed & (nz[i] >= 0)).sum())
        half = ((px >= lo[i, :, 0] - margin) & (px < hi[i, :, 0] + margin)
                & (py >= lo[i, :, 1] - margin) & (py < hi[i, :, 1] + margin))
        b2 += int((half & (ids[i] < 0)[..., None]).sum())
    assert (p1, p2) == (b1, b2)
    assert 0 < p2 < p1
    assert dibr_pairs.needed_per_step(cfg, inputs, [params, params]) \
        == p1 + 2 * p2
