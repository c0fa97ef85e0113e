"""Profiling helpers, the PyTorch counterpart of
``kaolin_tpu/utils/profiling.py``, and the port's own record of what it
does while ``torch.profiler`` runs.

The tools:

* :func:`trace`: context manager around ``torch.profiler.profile`` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace and the
  port's own record (``spans.json``) under one directory per label and
  yields the profiler, so that the caller can read ``key_averages()`` or
  ``events()``.
* :func:`time_fn`: wall-clock timing of a callable with warm-up, a device
  fence (:func:`sync`) after every batch of calls, and best-of-k repeats;
  returns a :class:`Timing` with per-call milliseconds.
* The record, one per process:

  - :func:`span` and :func:`backward_span` mark a layer's forward and its
    backward. While the profiler is off (``torch.autograd.profiler.
    _is_profiler_enabled``) they test that flag and do nothing else: no
    ``record_function``, no clock read, no hook. While it is on, each span
    is a ``record_function`` range, so it shows in exported traces, and a
    :class:`Span` in a bounded buffer, stamped by ``time.time_ns``: the
    clock of the profiler's host events, so a span lines up with the
    launch times of a trace.
  - :func:`count` keeps host counters (launches of the port's kernels),
    always on; :func:`device_counters` hands kernels int64 counters on the
    card that count their work while the profiler is on, and
    :func:`device_counter` hands such a counter to code that adds to it
    with tensor ops.
  - A session starts at the first instrumented call that finds the
    profiler on after one that found it off, and at :func:`trace`'s start:
    the span buffer and the device counters start afresh there.
    :func:`spans` and :func:`counters` read the current session.

Example::

    from kaolin_tpu_torch.utils.profiling import trace, time_fn

    t = time_fn(lambda: step(x))            # -> Timing(ms=...)
    with trace("step") as prof:             # writes <dir>/step/trace.json
        step(x)                             # and <dir>/step/spans.json
    print(prof.key_averages().table(row_limit=10))
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd import Variable
from torch.profiler import record_function as _record_function

__all__ = ["trace", "time_fn", "sync", "Timing", "default_trace_dir", "span",
           "backward_span", "current", "count", "device_counters",
           "device_counter", "spans",
           "counters", "self_ns", "Span"]


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

    CPU activity always, CUDA activity when a card is present. The block is
    a session of the port's record of its own. On exit the Chrome trace is
    written to ``<trace_dir>/<label>/trace.json`` (open it in Perfetto or
    ``chrome://tracing``), and the session's spans, each with its self
    time, and counters to ``spans.json`` beside it. Synchronise inside the
    block if the device work it enqueues must be in the trace."""
    global _was_on
    out = os.path.join(trace_dir or default_trace_dir(), label)
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        _start_session()
        _was_on = True
        yield prof
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    records = spans()
    own = self_ns(records)
    with open(os.path.join(out, "spans.json"), "w") as f:
        json.dump({"spans": [{**s._asdict(), "self_ns": own[s.id]}
                             for s in records],
                   "counters": counters()}, f)


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


# -- the port's own record: spans and counters -------------------------------

MAX_SPANS = 1 << 16   # spans a session keeps; later ones are counted, not kept


class Span(NamedTuple):
    """One closed span: its id and its parent's (None at the top), its
    name, the thread it ran on, and its start and end in ns on the
    profiler's clock (``time.time_ns``)."""

    id: int
    parent: int | None
    name: str
    thread: int
    start_ns: int
    end_ns: int


class _Session:
    def __init__(self):
        self.spans = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.zeroed = set()   # the device counters its launches have zeroed

    def add(self, record):
        if len(self.spans) < MAX_SPANS:
            self.spans.append(record)
        else:
            self.dropped += 1


_counts = {}          # host counters, always on
_counts_lock = threading.Lock()
_device_blocks = {}   # (names, device) -> int64 (len(names),) on the device
_session = _Session()
_was_on = False       # what the last instrumented call found
_local = threading.local()
_NOTHING = contextlib.nullcontext()
_clock = time.time_ns   # the clock of the profiler's host events


def _start_session():
    global _session
    _session = _Session()


def _on():
    """Whether the profiler is on; a call that finds it on after one that
    found it off starts a session."""
    global _was_on
    if not _autograd_profiler._is_profiler_enabled:
        _was_on = False
        return False
    if not _was_on:
        _start_session()
        _was_on = True
    return True


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current():
    """The id of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Open:
    """A span while the profiler is on. ``nested``: its parent defaults to
    the innermost span open on this thread, and it is that thread's
    innermost while it is open."""

    __slots__ = ("name", "parent", "nested", "id", "start", "rf", "session")

    def __init__(self, name, parent, nested=True):
        self.name, self.parent, self.nested = name, parent, nested

    def __enter__(self):
        self.session = _session
        self.id = next(self.session.ids)
        if self.nested:
            stack = _stack()
            if self.parent is None and stack:
                self.parent = stack[-1]
            stack.append(self.id)
        self.start = _clock()
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = _clock()
        stack = _stack()
        if self.nested and self.id in stack:
            stack.remove(self.id)
        self.session.add(Span(self.id, self.parent, self.name,
                              threading.get_ident(), self.start, end))


def span(name, parent=None):
    """Context manager: the span ``name`` around the enclosed block. Its
    parent is ``parent`` where given, else the innermost span open on this
    thread. While the profiler is off it is a shared no-op."""
    if not _on():
        return _NOTHING
    return _Open(name, parent)


class _BackwardSpan:
    """The span of one layer's backward: opened by a pre-hook on the node
    that takes the layer's output gradient, closed by post-hooks on the
    nodes that give the inputs theirs, once each of them ran (or at the end
    of the backward, for those the engine skips). It holds no node, so
    the graph frees it with itself."""

    def __init__(self, name, parent, n_entries):
        self.name, self.parent, self.n_entries = name, parent, n_entries
        self.open = None

    def opened(self, grad_outputs):
        if self.open is not None or not _on():
            return
        self.left = self.n_entries
        self.open = _Open(self.name, self.parent, nested=False)
        self.open.__enter__()
        Variable._execution_engine.queue_callback(self.close)

    def entry_ran(self, grad_inputs, grad_outputs):
        if self.open is not None:
            self.left -= 1
            if self.left == 0:
                self.close()

    def close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def _entry_nodes(root, inputs):
    """The nodes of the graph from ``root`` to ``inputs`` (tensors that
    require grad) that pass a gradient straight to one of them."""
    ends = {(t.grad_fn, t.output_nr) for t in inputs if t.grad_fn is not None}
    leaves = {id(t) for t in inputs if t.grad_fn is None}
    found, seen, todo = [], {root}, [root]
    while todo:
        node = todo.pop()
        entry = False
        for nxt, nr in node.next_functions:
            if nxt is None:
                continue
            if (nxt, nr) in ends or id(getattr(nxt, "variable", None)) \
                    in leaves:
                entry = True
            elif nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        if entry:
            found.append(node)
    return found


def backward_span(name, inputs, output):
    """Mark the backward of the layer that made ``output`` from ``inputs``
    (every tensor it takes that may require grad) as the span
    ``<name>.backward``, child of the innermost span open here (call it
    inside the layer's forward span).

    The span opens when the gradient of ``output`` reaches the node that
    made it, and closes once the nodes that pass the gradients to
    ``inputs`` have run: the layer's own nodes and no other, since autograd
    runs a device's nodes in the reverse of the order they were made. It
    runs on autograd's engine thread. It adds no autograd node and no
    launch; while the profiler is off, or where ``output`` does not
    require grad, it registers nothing."""
    if not _on() or output.grad_fn is None:
        return
    watched = [t for t in inputs if t is not None and t.requires_grad]
    entries = _entry_nodes(output.grad_fn, watched)
    if not entries:
        return
    bs = _BackwardSpan(name + ".backward", current(), len(entries))
    output.grad_fn.register_prehook(bs.opened)
    for node in entries:
        node.register_hook(bs.entry_ran)


def count(name, n=1):
    """Add ``n`` to the host counter ``name`` (always on; ``n=0`` lists it
    at 0)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def device_counters(names, device):
    """int64 counters ``names`` on ``device`` for one kernel launch that
    adds to them → (their address, whether the launch must zero them before
    it adds), or (None, False) while the profiler is off.

    They are allocated at the first call on a device, whether the profiler
    is on or not, and never zeroed by a launch of their own: the first
    launch of each session that is given them zeroes them, so a traced
    window holds no extra launch."""
    key = (tuple(names), torch.device(device))
    block = _device_blocks.get(key)
    if block is None:
        block = _device_blocks[key] = torch.empty(len(names),
                                                  dtype=torch.int64,
                                                  device=device)
    if not _on():
        return None, False
    reset = key not in _session.zeroed
    _session.zeroed.add(key)
    return block.data_ptr(), reset


def device_counter(name, device):
    """The int64 counter ``name`` on ``device`` (a (1,) tensor) for code
    that adds to it with tensor ops, zeroed at its first use in a session,
    or None while the profiler is off. :func:`counters` reads it as it
    reads :func:`device_counters`."""
    key = ((name,), torch.device(device))
    if key not in _device_blocks:
        _device_blocks[key] = torch.zeros(1, dtype=torch.int64,
                                          device=device)
    if not _on():
        return None
    if key not in _session.zeroed:
        _session.zeroed.add(key)
        _device_blocks[key].zero_()
    return _device_blocks[key]


def spans():
    """The current session's closed spans, in the order they closed."""
    return list(_session.spans)


def counters():
    """The host counters, the current session's device counters (read from
    the device: synchronise first) and ``utils.profiling.spans_dropped``,
    the spans past :data:`MAX_SPANS` the session did not keep."""
    with _counts_lock:
        out = dict(_counts)
    session = _session
    for key in session.zeroed:
        for name, value in zip(key[0], _device_blocks[key].tolist()):
            out[name] = out.get(name, 0) + value
    out["utils.profiling.spans_dropped"] = session.dropped
    return out


def self_ns(records):
    """{span id: its duration less its children's} over ``records``; a
    backward span, which runs after its forward parent, is not inside
    it."""
    by_id = {s.id: s for s in records}
    own = {s.id: s.end_ns - s.start_ns for s in records}
    for s in records:
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread \
                and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns:
            own[p.id] -= s.end_ns - s.start_ns
    return own
