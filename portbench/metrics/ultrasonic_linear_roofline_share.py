"""The linear-scale dB function's share of its roofline at 192 kHz and
above, %: the least time of those tracks' planes (``roofline.linear_work``
at the card's peaks) times the opens, over the device time of the kernels,
not copies or sets, whose interval overlaps one of the
``add_tracks.linear_minmax`` stages that called the linear route at those
rates (``ultrasonic_linear_ms.open``'s stages).  A kernel is picked by
overlap, not by where its device start falls: the trace maps device times
up to 1.7 ms early against the host's spans, so a kernel launched inside a
stage may appear to start before it.  The least time counts the function,
a real FFT of n_fft points a frame, so any implementation is held to the
same floor."""

import bisect

from portbench import registry, roofline, trace

_ms = registry.metric("ultrasonic_linear_ms.open")


def overlap_ns(events, stage_spans) -> int:
    """Device time of the kernels whose interval overlaps one of the spans,
    each kernel counted once."""
    iv = trace.merged((s.start_ns, s.end_ns) for s in stage_spans)
    starts = [a for a, _ in iv]
    ns = 0
    for _, kind, a, b, _ in events:
        i = bisect.bisect_left(starts, b) - 1  # the last span starting before b
        if kind == "kernel" and i >= 0 and iv[i][1] > a:
            ns += b - a
    return ns


def read(run):
    got = _ms.ultrasonic_stages(run)
    if not got or not run.events or not run.counts["opens"]:
        return None
    ns = overlap_ns(run.events, got)
    if not ns:
        return None
    least = sum(roofline.least_seconds(*roofline.linear_work(
        t["pcm"].shape[1], t["sr"], run.config["setting"]))
        for t in run.tracks if t["sr"] >= _ms.MIN_SR)
    return 100.0 * run.counts["opens"] * least / (ns / 1e9)
