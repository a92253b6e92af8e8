"""Opening a session: a fresh ``MultiTrack``, ``add_tracks`` of all the
configuration's files in one call, then the first screen, one track after
another: the spectrogram and waveform crops of the page's first stage,
PNG-encoded as the viewer sends them.  Opens run back to back; an open
ends when the last PNG's bytes exist.  The files stay in the page cache,
as for a user reopening a session."""

import gc
import time

import numpy as np


def _open(run):
    from msv_tpu_torch.io.png import encode_png
    from msv_tpu_torch.session import MultiTrack

    p = run.traffic
    mt = MultiTrack(run.setting(), device=run.device)
    ids = list(range(len(run.tracks)))
    with run.span("add_tracks"):
        mt.add_tracks(ids, [t["path"] for t in run.tracks])
    images = []
    for tid in ids:
        for kind in ("spec", "wav"):
            with run.span("render_" + kind):
                if kind == "spec":
                    img = mt.get_spec_image_crop(
                        tid, p["px_per_sec"], p["spec_height"], p["start"],
                        p["end"])
                else:
                    img = mt.get_wav_image_crop(
                        tid, p["px_per_sec"], p["wav_height"], -p["amp"],
                        p["amp"], p["start"], p["end"])
            with run.span("encode_png"):
                png = encode_png(img)
            images.append({"kind": kind, "id": tid, "pps": p["px_per_sec"],
                           "height": p[kind + "_height"], "start": p["start"],
                           "end": p["end"], "amp": p["amp"], "png": png})
    return mt, images


def setup(run):
    # every shape of an open: the kernels' first build and launch, the
    # render weights, the page cache
    for _ in range(run.traffic["warm_opens"]):
        mt, _ = _open(run)
        del mt
        gc.collect()
    run.spans.clear()
    run.host_spans.clear()
    # the open whose outputs are judged, drawn from the seed
    return {"judge": int(np.random.default_rng(run.seed).integers(0, 3)),
            "kept": None}


def window(run, state, seconds):
    t0 = time.perf_counter()
    n, took = 0, []
    while True:
        run.counts["attempted"] += 1  # an open that raises ends the run
        o0 = time.perf_counter()
        mt, images = _open(run)
        took.append(time.perf_counter() - o0)
        run.add_stages(mt.timer.summary())
        n += 1
        done = time.perf_counter() - t0 >= seconds
        if n - 1 == state["judge"] or (done and state["kept"] is None):
            state["kept"] = (mt, images)
        del mt, images
        if done:
            break
    run.sync()
    wall = time.perf_counter() - t0
    run.counts["opens"] = n
    run.samples = took
    return {"open_s": wall / n}


def outputs(run, state):
    mt, images = state.pop("kept")
    out = {"planes": {tid: mt.get_spec_db(tid) for tid in mt.tracks},
           "range": (mt.get_max_db(), mt.get_min_db()),
           "images": images, "failed": run.counts["failed"]}
    del mt
    gc.collect()
    return out
