"""One ``torch.profiler`` trace of a window, reduced to what the per-layer
metrics read.

Everything comes from the one trace: the window is the benchmark's own
``record_function`` range ``WINDOW``, which ends after a synchronize; the
device's work is every kernel, copy and fill on the card (every event on
the device but the copies of host ranges); an operation belongs
to a span (a ``record_function`` range of the benchmark's) where the host
call that launched it (linked by CUDA's correlation id) falls inside the
span on the host clock, on any thread, so the backward's engine thread
counts under ``backward``.
"""

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

WINDOW = "portbench.window"
# host calls that put work on the device carry CUDA's correlation id
LAUNCH_PREFIXES = ("cuda", "cu")


class Trace:
    """The window's device work and spans.

    ``ops``: (name, start ns, end ns, host launch ns or None) of each
    device operation; ``spans``: {name: sorted [(start ns, end ns)]} of the
    ranges named in ``span_names``; ``window``: (start ns, end ns);
    ``steps``: the steps in the window."""

    def __init__(self, events, steps, span_names):
        names = set(span_names) | {WINDOW}
        launches = {}
        device = []
        host_names = set()
        spans = defaultdict(list)
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                device.append((name, e.start_ns(), e.end_ns(),
                               e.correlation_id(), e.linked_correlation_id()))
                continue
            host_names.add(name)
            if name in names:
                spans[name].append((e.start_ns(), e.end_ns()))
            elif name.startswith(LAUNCH_PREFIXES):
                launches[e.correlation_id()] = e.start_ns()
        # a range of record_function has a copy on the device's timeline
        # under its own name; no kernel, copy or fill shares a host name
        device = [d for d in device if d[0] not in host_names]
        if len(spans.get(WINDOW, ())) != 1:
            raise RuntimeError(f"the trace holds {len(spans.get(WINDOW, ()))}"
                               f" ranges named {WINDOW}, not one")
        self.window = spans.pop(WINDOW)[0]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        lo, hi = self.window
        self.ops = sorted(((name, s, e, launches.get(c, launches.get(lc)))
                           for name, s, e, c, lc in device if lo <= s <= hi),
                          key=lambda op: op[1])
        self.op_spans = [self.span_of(op[3]) for op in self.ops]
        self.steps = steps

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, merged, in
        order, clipped to the window."""
        merged = []
        for _, s, e, _ in self.ops:
            e = min(e, self.window[1])
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def span_of(self, t):
        """The benchmark span open on the host at ``t`` ns, or None."""
        if t is None:
            return None
        for name, ranges in self.spans.items():
            i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
            if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
                return name
        return None

    def span_device_s(self, name):
        """Device seconds per step of the operations launched inside the
        spans named ``name``."""
        total = sum(op[2] - op[1] for op, span in zip(self.ops,
                                                      self.op_spans)
                    if span == name)
        return total / 1e9 / self.steps

    def named_device_s(self, patterns):
        """Device seconds per step of the operations whose name holds one of
        ``patterns``; 0 where none does."""
        total = sum(e - s for n, s, e, _ in self.ops
                    if any(p in n for p in patterns))
        return total / 1e9 / self.steps

    def launches_per_step(self):
        return len(self.ops) / self.steps

    def breakdown(self, top=10):
        """{"device_ops": [[name, device s per step]], "idle_gaps": [[span
        that launched the operation the device waited for, idle s per
        step]]}, the largest ``top`` of each."""
        by_name = defaultdict(int)
        for n, s, e, _ in self.ops:
            by_name[n] += e - s
        gaps = defaultdict(int)
        merged = self.busy_intervals()
        starts = [op[1] for op in self.ops]
        edge = self.window[0]
        for s, e in merged + [[self.window[1], self.window[1]]]:
            if s > edge:
                i = bisect.bisect_left(starts, s)
                who = "end_of_window" if i == len(self.ops) \
                    else self.op_spans[i] or "between_steps"
                gaps[who] += s - edge
            edge = max(edge, e)

        def rows(d):
            return [[k, v / 1e9 / self.steps]
                    for k, v in sorted(d.items(), key=lambda x: -x[1])[:top]]

        return {"device_ops": rows(by_name), "idle_gaps": rows(gaps)}
