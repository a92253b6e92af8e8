"""Decode and sum to mono, seconds an open: the sessions'
``add_tracks.decode`` stage over the window's opens."""


def read(run):
    calls, total = run.stages.get("add_tracks.decode", (0, 0.0))
    if not calls or not run.counts["opens"]:
        return None
    return total / run.counts["opens"]
