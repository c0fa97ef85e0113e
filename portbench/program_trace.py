"""The port's own record of a traced window, for the per-layer metrics that
read it: the spans and counters of ``kaolin_tpu_torch.utils.profiling``.

The port stamps its spans with ``time.time_ns``, the clock of the
profiler's host events, so they line up with the trace's window and with
each operation's host launch (``Trace.ops``). Only spans inside the window
count. Without a trace, or with a port that keeps no such record, every
function here gives None.
"""

import bisect


def _record():
    """The port's profiling module where it keeps spans and counters, else
    None."""
    try:
        from kaolin_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or not hasattr(profiling, "counters"):
        return None
    return profiling


def spans(run, name):
    """Sorted [(start ns, end ns)] of the port's spans ``name`` that lie
    inside the traced window; None where there are none."""
    prof = _record()
    if run.trace is None or prof is None:
        return None
    lo, hi = run.trace.window
    found = sorted((s.start_ns, s.end_ns) for s in prof.spans()
                   if s.name == name and lo <= s.start_ns and s.end_ns <= hi)
    return found or None


def counters(run):
    """The port's counters of the traced window's session, or None."""
    prof = _record()
    if run.trace is None or prof is None:
        return None
    return prof.counters()


def _inside(ranges, t):
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def device_ms(run, name):
    """Device ms per step of the operations whose host launch falls inside
    one of the spans ``name``; None without such spans or such operations."""
    ranges = spans(run, name)
    if ranges is None:
        return None
    total = sum(e - s for _, s, e, launch in run.trace.ops
                if launch is not None and _inside(ranges, launch))
    return total / 1e6 / run.trace.steps if total > 0 else None


def idle_ms(run, name):
    """Ms per step in which the device ran nothing while the host was
    inside one of the spans ``name``: the window's idle intervals (the
    complement of ``Trace.busy_intervals``) within the spans. None without
    such spans or without device work."""
    ranges = spans(run, name)
    if ranges is None or not run.trace.ops:
        return None
    lo, hi = run.trace.window
    idle, edge = [], lo
    for s, e in run.trace.busy_intervals() + [[hi, hi]]:
        if s > edge:
            idle.append((edge, s))
        edge = max(edge, e)
    starts = [s for s, _ in idle]
    total = 0
    for a, b in ranges:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(idle) and idle[i][0] < b:
            total += max(0, min(b, idle[i][1]) - max(a, idle[i][0]))
            i += 1
    return total / 1e6 / run.trace.steps
