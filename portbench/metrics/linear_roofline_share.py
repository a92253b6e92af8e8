"""The linear-scale dB function's share of its roofline over the traced
window, %: the least time of every open's planes (``roofline.linear_work``
of each track, at the card's peaks) over the device time of the kernels,
not copies or sets, that start inside the sessions'
``add_tracks.linear_minmax`` program spans: whatever kernels carry the
route (GEMMs, magnitude, dB, masked min/max), the function's floor stays
the same."""

import bisect

from portbench import roofline, spans

STAGE = "add_tracks.linear_minmax"


def kernel_ns(events, stage_spans) -> int:
    """Device time of the kernels that start inside one of the spans."""
    iv = sorted((s.start_ns, s.end_ns) for s in stage_spans)
    starts = [a for a, _ in iv]
    ns = 0
    for _, kind, a, b, _ in events:
        i = bisect.bisect_right(starts, a) - 1
        if kind == "kernel" and i >= 0 and a < iv[i][1]:
            ns += b - a
    return ns


def read(run):
    got = spans.in_window(run, STAGE)
    if not got or not run.events or not run.counts["opens"]:
        return None
    ns = kernel_ns(run.events, got)
    if not ns:
        return None
    least = sum(roofline.least_seconds(*roofline.linear_work(
        t["pcm"].shape[1], t["sr"], run.config["setting"]))
        for t in run.tracks)
    return 100.0 * run.counts["opens"] * least / (ns / 1e9)
