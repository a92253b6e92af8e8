"""The linear route (the DFT GEMM pair, magnitude, dB and masked min/max)
with its one sync, milliseconds an open: the sessions'
``add_tracks.linear_minmax`` stage."""


def read(run):
    calls, total = run.stages.get("add_tracks.linear_minmax", (0, 0.0))
    if not calls or not run.counts["opens"]:
        return None
    return 1e3 * total / run.counts["opens"]
