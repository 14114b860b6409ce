"""The profiler's reduction: from ``torch.profiler`` events of a traced
sub-window to device busy time, kernel time by name, the device time of
the kernels launched inside the harness's own spans, and the idle gaps by
what the host was doing."""

from typing import NamedTuple

from . import stats

WINDOW = "kbench.window"  # the span around the traced calls
SPAN = "kbench."  # the prefix of the harness's own spans


class Trace(NamedTuple):
    window_s: float  # the length of the traced window
    busy_s: float  # time in which some operation ran on the device
    kernels: dict  # device operation name -> [seconds, count]
    spans: dict  # harness span name -> device seconds of the kernels launched inside
    gaps: dict  # host operation in progress -> idle seconds of the device


def _device_time(e):
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def reduce(events):
    """A :class:`Trace` of the profiler's ``events()`` (times in us)."""
    from torch.autograd import DeviceType

    windows = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} spans named {WINDOW}")
    win = windows[0]
    lo, hi = win.time_range.start, win.time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(SPAN)]
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    busy = stats.union_length(intervals, lo, hi)
    kernels = {}
    for e in device:
        row = kernels.setdefault(e.name, [0.0, 0])
        row[0] += (e.time_range.end - e.time_range.start) * 1e-6
        row[1] += 1
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(SPAN) and e.name != WINDOW:
            spans[e.name] = spans.get(e.name, 0.0) + _device_time(e) * 1e-6
    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and e.thread == win.thread and lo <= e.time_range.start <= hi),
                  key=lambda e: (e.time_range.start, -e.time_range.end))
    return Trace((hi - lo) * 1e-6, busy * 1e-6, kernels, spans,
                 _gap_owners(host, stats.gaps(intervals, lo, hi)))


def _gap_owners(host, gaps):
    """Idle seconds by the innermost host operation in progress at each
    gap's middle (the harness's spans count as the solver's Python).
    ``host``: one thread's events by start; they nest, so one sweep with a
    stack of the open ones finds each owner."""
    out, stack, j = {}, [], 0
    for s, e in gaps:  # in time order
        mid = 0.5 * (s + e)
        while j < len(host) and host[j].time_range.start <= mid:
            ev = host[j]
            while stack and stack[-1].time_range.end < ev.time_range.start:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        owner = stack[-1].name if stack else "no host operation"
        if owner.startswith(SPAN):
            owner = "Python between operations"
        out[owner] = out.get(owner, 0.0) + (e - s) * 1e-6
    return out


def top(table, n=10):
    """The ``n`` largest entries of ``{name: seconds}`` as ``[[name, s], ...]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
