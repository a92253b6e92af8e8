"""What the profiler saw: device busy time, idle share, the device
operations that took most time and what the host did while the device
was idle.

Events are plain ``(name, kind, start_ns, end_ns, thread)`` tuples, so
the arithmetic is tested on synthetic lists.  ``kind`` is the profiler's
activity type: "kernel", "gpu_memcpy" and "gpu_memset" run on the device;
"user_annotation" marks the harness's window (``pb.window``).  The
harness's spans come apart, as ``(name, start_ns, end_ns)`` on the same
wall clock.
"""

from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb."
WINDOW = "pb.window"


def _kind(e) -> str:
    """The activity type of a kineto event (older PyTorch builds lack
    ``activity_type``: then from its device, annotation flag and name)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    user = e.is_user_annotation()
    if "CUDA" not in str(e.device_type()):
        return "user_annotation" if user else "cpu_op"
    name = e.name()
    if user or name.startswith(SPAN_PREFIX):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if "Sync" in name:
        return "cuda_sync"
    return "kernel"


def events_of(prof):
    """The tuples of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), _kind(e), start, start + e.duration_ns(),
                    e.start_thread_id()))
    return out


def window_of(events, name=WINDOW):
    """(start_ns, end_ns) of the harness's window span."""
    for n, kind, a, b, _ in events:
        if n == name and kind == "user_annotation":
            return a, b
    raise ValueError(f"no {name} span in the trace")


def device_intervals(events, window):
    """Device operations clipped to the window, sorted by start."""
    w0, w1 = window
    out = []
    for n, kind, a, b, _ in events:
        if kind in DEVICE_KINDS and b > w0 and a < w1:
            out.append((max(a, w0), min(b, w1), n))
    out.sort()
    return out


def merged(intervals):
    """The union of (start, end, ...) intervals as sorted disjoint
    (start, end) pairs."""
    out = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(intervals) -> int:
    return sum(b - a for a, b in merged(intervals))


def idle_share(intervals, window) -> float:
    """1 - (union of device operations) / window."""
    return 1.0 - busy_ns(intervals) / (window[1] - window[0])


def top_device_ops(intervals, n=10):
    """[[name, seconds], ...]: the device operations with the most time."""
    acc = defaultdict(int)
    for a, b, name in intervals:
        acc[name] += b - a
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], ns / 1e9] for name, ns in top]


def idle_gaps(spans, intervals, window, n=10):
    """[[host activity, seconds], ...]: the device's idle time inside the
    window, summed by the innermost of the harness's spans
    (``(name, start_ns, end_ns)``, any thread) that covers the middle of
    each gap ("no span" where none does)."""
    w0, w1 = window
    gaps, t = [], w0
    for a, b in merged(intervals):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    spans = sorted((a, b, name) for name, a, b in spans)
    acc = defaultdict(int)
    active, i = [], 0
    for a, b in gaps:  # in time order: a sweep over the spans
        mid = (a + b) // 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > mid]
        best = min(active, key=lambda s: s[1] - s[0], default=None)
        acc[best[2] if best else "no span"] += b - a
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]
