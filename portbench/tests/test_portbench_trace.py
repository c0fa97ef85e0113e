"""The trace's reduction and the per-layer readers, on a trace made up
here: what each metric reads from which spans and operations."""

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.roofline import dibr as roof
from portbench.trace import WINDOW, Trace


class Ev:
    def __init__(self, kind, name, start, end, corr=0):
        self.kind, self.n, self.s, self.e, self.c = kind, name, start, end, \
            corr

    def device_type(self):
        return DeviceType.CUDA if self.kind.startswith("gpu") \
            else DeviceType.CPU

    def linked_correlation_id(self):
        return 0

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c


def _trace():
    ms = 1_000_000
    ev = [Ev("cpu_annotation", WINDOW, 0, 100 * ms),
          Ev("cpu_annotation", "render_fwd", 0, 10 * ms),
          Ev("cpu_annotation", "backward", 20 * ms, 60 * ms),
          Ev("cpu_annotation", "optimizer", 60 * ms, 70 * ms),
          Ev("cuda_runtime", "cudaLaunchKernel", 1 * ms, 2 * ms, 1),
          Ev("cuda_runtime", "cudaLaunchKernel", 3 * ms, 4 * ms, 2),
          Ev("cuda_runtime", "cudaLaunchKernel", 30 * ms, 31 * ms, 3),
          Ev("cuda_runtime", "cudaMemsetAsync", 61 * ms, 62 * ms, 4),
          Ev("gpu_kernel", "void winner_kernel<8>(x)", 5 * ms, 15 * ms, 1),
          Ev("gpu_kernel", "winner_box_kernel", 15 * ms, 20 * ms, 2),
          Ev("gpu_kernel", "soft_bwd_kernel", 40 * ms, 50 * ms, 3),
          Ev("gpu_memset", "Memset", 65 * ms, 66 * ms, 4),
          Ev("gpu_annotation", "backward", 40 * ms, 50 * ms, 0),
          Ev("cpu_annotation", "Optimizer.step#Adam.step", 60 * ms, 61 * ms),
          Ev("gpu_annotation", "Optimizer.step#Adam.step", 65 * ms, 66 * ms),
          Ev("cpu_op", "aten::mul", 0, 1, 9)]
    return Trace(ev, 2, ("render_fwd", "texture_fwd", "loss", "backward",
                         "optimizer"))


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.026)
    assert t.launches_per_step() == 2
    assert t.span_device_s("render_fwd") == pytest.approx(0.0075)
    assert t.span_device_s("backward") == pytest.approx(0.005)
    assert t.span_device_s("optimizer") == pytest.approx(0.0005)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void winner_kernel<8>(x)", 0.005]
    gaps = dict(b["idle_gaps"])
    # 5 ms before the first kernel (launched in render_fwd), 20 ms before
    # the backward's, 15 before the memset, 34 after the last
    assert gaps["render_fwd"] == pytest.approx(0.0025)
    assert gaps["backward"] == pytest.approx(0.01)
    assert gaps["optimizer"] == pytest.approx(0.0075)
    assert gaps["end_of_window"] == pytest.approx(0.017)
    assert roof.kernels_ms(t) == pytest.approx(12.5)


def test_readers():
    run = harness.Run(trace=_trace(), steps=10, window_s=2.0,
                      step_ms=[1.0] * 19 + [5.0], setup_s=3.0,
                      peak_bytes=2 ** 31, geometry=[])
    read = {n: harness.reader(n)(run) for n in
            ("fit_steps_per_s", "step_ms_p95", "peak_mem_GiB", "setup_s",
             "device_idle_share", "launches_per_step", "dibr_kernels_ms",
             "render_fwd_ms", "texture_fwd_ms", "backward_ms",
             "optimizer_ms")}
    assert read["fit_steps_per_s"] == 5.0
    assert read["peak_mem_GiB"] == 2.0
    assert read["device_idle_share"] == pytest.approx(74.0)
    assert read["dibr_kernels_ms"] == pytest.approx(12.5)
    assert read["render_fwd_ms"] == pytest.approx(7.5)
    assert read["texture_fwd_ms"] is None     # no such span
    assert read["backward_ms"] == pytest.approx(5.0)
    empty = harness.Run(trace=None, steps=1, window_s=1.0, step_ms=[1.0],
                        setup_s=1.0, peak_bytes=None, geometry=[])
    for n in ("step_ms_p95", "peak_mem_GiB", "device_idle_share",
              "launches_per_step", "dibr_kernels_ms",
              "dibr_kernels_roofline", "backward_ms"):
        assert harness.reader(n)(empty) is None, n
