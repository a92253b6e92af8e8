"""The mel kernel's groups at 192 kHz and above, milliseconds an open: each
group's ``add_tracks.kernel_minmax`` stage (its launch, its masked min/max
and the one sync that ends it), for the stages that hold a ``mel.launch``
program span with ``sr`` 192 000 or more.  The launch's own span ends when
the launch returns, before the kernel does; its stage ends on the device's
time."""

from portbench import spans

MIN_SR = 192000
STAGE = "add_tracks.kernel_minmax"


def ultrasonic_stages(run):
    """The window's ``add_tracks.kernel_minmax`` spans that launched the mel
    kernel at ``MIN_SR`` or above; None where the program records no
    ``mel.launch`` span there."""
    launches = spans.in_window(run, "mel.launch")
    if not launches:
        return None
    parents = {s.parent_id for s in launches
               if (s.attrs.get("sr") or 0) >= MIN_SR}
    got = [s for s in spans.in_window(run, STAGE) if s.span_id in parents]
    return got or None


def read(run):
    got = ultrasonic_stages(run)
    if not got or not run.counts["opens"]:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / run.counts["opens"]
