"""Segmented streaming of long tracks, seconds an open: the sessions'
``add_tracks.streaming`` stage."""


def read(run):
    calls, total = run.stages.get("add_tracks.streaming", (0, 0.0))
    if not calls or not run.counts["opens"]:
        return None
    return total / run.counts["opens"]
