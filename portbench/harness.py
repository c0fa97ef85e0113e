"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

- a configuration's file (its ``file`` entry) names its fit, a module
  ``portbench/fits/<fit>.py`` (the user's loop over the port) with a plain
  reference ``portbench/reference/<fit>_fit.py`` beside it, which also
  gives the numbers that decide ``correct`` (``numbers``), judged against
  the configuration's ``limits``;
- a traffic mix is ``portbench/traffic/<traffic>.json``, read by
  :mod:`portbench.traffic`;
- a metric is a reader ``portbench/metrics/<name>.py`` whose ``read(run)``
  returns the number, or None where the run holds nothing to read.
"""

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import traffic
from portbench.reference.compare import judge
from portbench.trace import WINDOW, Trace

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# steps a traced window holds at most, so its trace stays small
TRACE_STEPS = 200
JAX_NAMES = ("jax", "jaxlib", "flax", "kaolin_tpu")


def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench, workload):
    """(workload entry, configuration entry, configuration, mix)."""
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    return wl, entry, cfg, traffic.load(wl["traffic"])


def metrics_of(bench, workload, per_layer):
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``per_layer`` its per-layer ones."""
    group = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start():
    """When this process started, on ``time.clock_gettime(CLOCK_BOOTTIME)``
    (Linux: ``/proc/self/stat``'s start time in clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def now():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


class Run:
    """What a run measured, as the metric readers take it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Marks:
    """Step ends: CUDA events on the card, the host clock on the CPU (where
    every step ends before it returns)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(fit, state, seconds, device, max_steps=None):
    """Steps of ``fit`` for ``seconds`` (or ``max_steps``), ending in a
    synchronize → (steps, window s, step intervals ms, losses)."""
    marks = _Marks(device)
    losses = []
    sync(device)
    t0 = time.perf_counter()
    marks.mark()
    while True:
        loss, _ = fit.step(state)
        losses.append(loss)
        marks.mark()
        if time.perf_counter() - t0 >= seconds \
                or (max_steps and len(losses) >= max_steps):
            break
    sync(device)
    return (len(losses), time.perf_counter() - t0, marks.intervals_ms(),
            losses)


def traced_window(fit, state, seconds, device):
    """:func:`window` of at most ``TRACE_STEPS`` steps under the profiler
    → (its result, the :class:`Trace`)."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = window(fit, state, seconds, device, TRACE_STEPS)
    return out, Trace(prof.profiler.kineto_results.events(), out[0],
                      fit.SPANS)


def run_cell(workload, seed, seconds, trace, device="cuda", t_start=None,
             bench=None, cfg=None):
    """One run of ``workload`` on ``device`` → the result's dict, with the
    numbers compared and their limits under ``checks``, last. ``cfg``, when
    given, stands in for the configuration's file (the tests' small
    copies)."""
    t_start = now() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    wl, _, file_cfg, mix = cell(bench, workload)
    cfg = file_cfg if cfg is None else cfg
    cuda = torch.device(device).type == "cuda"
    phases = {"start": t_start}
    fit = importlib.import_module(f"portbench.fits.{cfg['fit']}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases["imports and device"] = now()
    inputs = fit.make_inputs(cfg, mix, seed, device)
    phases["inputs"] = now()
    state = fit.build(cfg, inputs, device)
    phases["build"] = now()
    record = fit.first_steps(state, cfg["checked_steps"])
    sync(device)
    phases["checked steps"] = now()
    for _ in range(cfg["warmup_steps"]):
        fit.step(state)
    sync(device)
    phases["warm-up"] = now()
    setup_s = phases["warm-up"] - t_start
    times = list(phases.values())
    print("set-up: " + ", ".join(f"{k} {b - a:.3f} s" for k, a, b in zip(
        list(phases)[1:], times, times[1:])), file=sys.stderr)

    geometry = [fit.geometry(state)] if trace else []
    if trace:
        (steps, window_s, step_ms, losses), tr = traced_window(
            fit, state, seconds, device)
        geometry.append(fit.geometry(state))
    else:
        steps, window_s, step_ms, losses = window(fit, state, seconds,
                                                  device)
        tr = None
    peak = torch.cuda.max_memory_allocated() if cuda else None
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del state, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref_fit = importlib.import_module(f"portbench.reference.{cfg['fit']}_fit")
    ref = ref_fit.run(cfg, inputs, cfg["checked_steps"])
    correct, rows = judge(ref_fit.numbers(record, ref), cfg["limits"])
    print(f"set-up {setup_s:.3f} s, window {window_s:.3f} s ({steps} "
          f"steps), reference check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    run = Run(cfg=cfg, inputs=inputs, steps=steps,
              window_s=window_s, step_ms=step_ms, setup_s=setup_s,
              peak_bytes=peak, trace=tr, geometry=geometry)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def jax_loaded():
    """The modules in ``sys.modules`` whose top-level name is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)
