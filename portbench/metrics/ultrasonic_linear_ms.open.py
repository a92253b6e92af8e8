"""The linear route's groups at 192 kHz and above, milliseconds an open:
each group's ``add_tracks.linear_minmax`` stage (its call of the route, its
masked min/max and the one sync that ends it), for the stages that hold a
``linear.launch`` program span with ``sr`` 192 000 or more.  A program
without that span (before the route had one) reads nothing."""

from portbench import spans

MIN_SR = 192000
STAGE = "add_tracks.linear_minmax"


def ultrasonic_stages(run):
    """The window's ``add_tracks.linear_minmax`` spans that called the
    linear route at ``MIN_SR`` or above; None where the program records no
    ``linear.launch`` span there."""
    launches = spans.in_window(run, "linear.launch")
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
