"""The grouped mel kernel launches with their masked min/max and one sync,
milliseconds an open: the sessions' ``add_tracks.kernel_minmax`` stage."""


def read(run):
    calls, total = run.stages.get("add_tracks.kernel_minmax", (0, 0.0))
    if not calls or not run.counts["opens"]:
        return None
    return 1e3 * total / run.counts["opens"]
