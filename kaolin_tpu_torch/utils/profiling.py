"""Profiling helpers, the PyTorch counterpart of
``kaolin_tpu/utils/profiling.py``.

Two tools:

* :func:`trace`: context manager around ``torch.profiler.profile`` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace under
  one directory per label and yields the profiler, so that the caller can
  read ``key_averages()`` or ``events()``.
* :func:`time_fn`: wall-clock timing of a callable with warm-up, a device
  fence (:func:`sync`) after every batch of calls, and best-of-k repeats;
  returns a :class:`Timing` with per-call milliseconds.

Example::

    from kaolin_tpu_torch.utils.profiling import trace, time_fn

    t = time_fn(lambda: step(x))            # -> Timing(ms=...)
    with trace("step") as prof:             # writes <dir>/step/trace.json
        step(x)
    print(prof.key_averages().table(row_limit=10))
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

__all__ = ["trace", "time_fn", "sync", "Timing", "default_trace_dir"]


def _first_tensor(x):
    """The first tensor leaf of a tensor, or of nested lists, tuples and
    dict values; None if there is none."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for leaf in x:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait until the device of the first tensor leaf of ``x`` has finished
    all queued work (``torch.cuda.synchronize`` on that device). Nothing to
    wait for on the CPU, or when ``x`` holds no tensor."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def default_trace_dir() -> str:
    """Trace output root: ``$KAOLIN_TPU_TRACE_DIR``, else
    ``kaolin_tpu_traces`` in the temporary directory (``$TMPDIR``, else
    ``/tmp``)."""
    return os.environ.get("KAOLIN_TPU_TRACE_DIR",
                          os.path.join(tempfile.gettempdir(),
                                       "kaolin_tpu_traces"))


@contextlib.contextmanager
def trace(label: str, trace_dir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` and yield the
    profiler.

    CPU activity always, CUDA activity when a card is present. On exit the
    Chrome trace is written to ``<trace_dir>/<label>/trace.json`` (open it
    in Perfetto or ``chrome://tracing``). Synchronise inside the block if
    the device work it enqueues must be in the trace."""
    out = os.path.join(trace_dir or default_trace_dir(), label)
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


@dataclasses.dataclass
class Timing:
    """Wall-clock timing result of :func:`time_fn`."""

    ms: float          # best (min) per-call milliseconds
    mean_ms: float     # mean per-call milliseconds over repeats
    repeats: int
    calls_per_repeat: int

    def __str__(self):
        return (f"{self.ms:.3f} ms/call (mean {self.mean_ms:.3f}, "
                f"{self.repeats}x{self.calls_per_repeat} calls)")


def time_fn(fn: Callable[[], object], *, repeats: int = 5,
            calls_per_repeat: int = 10, warmup: int = 1) -> Timing:
    """Time a nullary callable returning tensors (or nests of them).

    Runs ``warmup`` untimed calls (at least one), then ``repeats`` timed
    batches of ``calls_per_repeat`` calls each, fencing every batch with
    :func:`sync` on the last call's result. Reports min and mean per-call
    time; calls within a batch overlap the host's enqueue with the
    device's work, so this is a throughput number."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    sync(out)

    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls_per_repeat):
            out = fn()
        sync(out)
        samples.append((time.perf_counter() - t0) / calls_per_repeat)
    return Timing(ms=min(samples) * 1e3,
                  mean_ms=sum(samples) / len(samples) * 1e3,
                  repeats=repeats, calls_per_repeat=calls_per_repeat)
