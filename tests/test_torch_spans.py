"""The port's program spans (``msv_tpu_torch.utils.profiling.span``), on
the CPU: recorded exactly while a torch profiler records, from any thread,
on the profiler's clock; the trees of a session open and of viewer
requests; and their export into ``utils.debug.device_trace``'s chrome
trace."""

import json
import os
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch  # noqa: E402
import msv_tpu_torch.viewer as V  # noqa: E402
from msv_tpu_torch.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.utils import debug, profiling  # noqa: E402
from msv_tpu_torch.utils.profiling import StageTimer, span  # noqa: E402

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _descendants(spans, root):
    out, todo = [], [root]
    while todo:
        kids = _children(spans, todo.pop())
        out += kids
        todo += kids
    return out


def _wavs(tmp_path):
    """A stereo and a mono PCM16 WAV, 2 s at 16 kHz."""
    rng = np.random.default_rng(5)
    t = np.arange(32000) / 16000
    tone = 0.3 * np.sin(2 * np.pi * 440 * t)
    stereo = str(tmp_path / "stereo.wav")
    mono = str(tmp_path / "mono.wav")
    write_wav(stereo, np.stack([tone, 0.1 * rng.standard_normal(len(t))])
              .astype(np.float32), 16000)
    write_wav(mono, tone[None].astype(np.float32), 16000)
    return stereo, mono


def test_without_a_profiler_nothing_is_recorded_and_no_clock_is_read(
        monkeypatch):
    def no_clock():
        raise AssertionError("span read the clock with tracing off")

    timer = StageTimer()
    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with span("a", request=True, k=1) as sp:
        sp.set(status=200)
        with timer.stage("b"):
            time.sleep(0.002)
    monkeypatch.undo()
    assert profiling.recorded() == [] and profiling.dropped() == 0
    got = timer.summary()
    assert list(got) == ["b"] and got["b"]["calls"] == 1
    assert got["b"]["total_s"] >= 0.002


def test_a_thread_started_inside_the_profiler_records_with_its_ids():
    ids = {}

    def work():
        ids["thread"] = threading.get_native_id()
        with span("outer", request=True, route="/x/"):
            with span("inner"):
                pass
        with span("alone"):
            pass

    with _profile():
        t = threading.Thread(target=work)
        t.start()
        t.join()
        with span("main"):
            pass
    spans = profiling.recorded()
    (outer,), (inner,), (alone,), (main,) = (
        _by_name(spans, n) for n in ("outer", "inner", "alone", "main"))
    assert {outer.thread_id, inner.thread_id, alone.thread_id} == {
        ids["thread"]}
    assert main.thread_id == threading.get_native_id() != ids["thread"]
    assert outer.parent_id is None and inner.parent_id == outer.span_id
    assert outer.request_id is not None
    assert inner.request_id == outer.request_id
    assert alone.request_id is None and alone.parent_id is None
    assert outer.attrs == {"route": "/x/"}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_a_span_contains_its_record_function_on_the_profiler_s_clock():
    with _profile() as prof:
        with span("outer"):
            with torch.profiler.record_function("probe.range"):
                torch.ones(1000).sum()
    (outer,) = _by_name(profiling.recorded(), "outer")
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.range"]
    a, b = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert outer.start_ns - MS <= a <= b <= outer.end_ns + MS


def test_many_threads_lose_no_span_and_mix_no_ids():
    n_threads, n_each = 24, 200
    errors = []

    def work():
        try:
            for _ in range(n_each):
                with span("req", request=True):
                    with span("child"):
                        pass
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = profiling.recorded()
    assert len(spans) == 2 * n_threads * n_each
    assert len({s.span_id for s in spans}) == len(spans)
    by_id = {s.span_id: s for s in spans}
    reqs = _by_name(spans, "req")
    assert len({s.request_id for s in reqs}) == len(reqs)
    for c in _by_name(spans, "child"):
        parent = by_id[c.parent_id]
        assert parent.name == "req" and parent.thread_id == c.thread_id
        assert c.request_id == parent.request_id


def test_the_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    assert profiling.MAX_SPANS >= 1 << 20
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with _profile():
        for _ in range(5):
            with span("x"):
                pass
    assert len(profiling.recorded()) == 2 and profiling.dropped() == 3
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_an_open_gives_the_add_tracks_tree(tmp_path):
    stereo, mono = _wavs(tmp_path)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    with _profile():
        mt.add_tracks([0, 1], [stereo, mono])
    spans = profiling.recorded()
    (root,) = _by_name(spans, "add_tracks")
    assert root.parent_id is None
    (decode,) = [s for s in _children(spans, root)
                 if s.name == "add_tracks.decode"]
    files = _children(spans, decode)
    assert [s.name for s in files] == ["decode.file"] * 2
    assert sorted(s.attrs["path"] for s in files) == ["mono.wav",
                                                       "stereo.wav"]
    for f in files:
        assert sorted(s.name for s in _children(spans, f)) == [
            "decode.mono", "decode.read"]
    under = {s.name for s in _descendants(spans, root)}
    assert {"add_tracks.operands", "add_tracks.spec", "add_tracks.host_prep",
            "add_tracks.h2d", "add_tracks.kernel_minmax",
            "add_tracks.budget", "add_tracks.db_state"} <= under
    for s in _descendants(spans, root):
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # one upload a group (the stereo sum and the mono PCM16 differ in wire),
    # under its h2d stage, of the carriers' own bytes
    h2d = _by_name(spans, "add_tracks.h2d")
    ups = _by_name(spans, "session.upload")
    assert len(ups) == len(h2d) == 2
    assert sorted(u.parent_id for u in ups) == sorted(s.span_id for s in h2d)
    carriers = {"i32": mt.tracks[0]._wav_int, "i16": mt.tracks[1]._wav_int}
    assert sorted(u.attrs["carrier"] for u in ups) == ["i16", "i32"]
    for u in ups:
        assert u.attrs == {"route": "device_pad", "tracks": 1,
                           "carrier": u.attrs["carrier"],
                           "bytes": carriers[u.attrs["carrier"]].nbytes}
    stages = mt.timer.summary()
    assert {"add_tracks", "add_tracks.decode", "add_tracks.operands",
            "add_tracks.spec", "add_tracks.host_prep", "add_tracks.h2d",
            "add_tracks.kernel_minmax", "add_tracks.budget",
            "add_tracks.db_state"} == set(stages)
    # every stage is a span of the same extent
    for name, st in stages.items():
        got = _by_name(spans, name)
        assert len(got) == st["calls"]
        ns = sum(s.end_ns - s.start_ns for s in got)
        assert abs(ns / 1e9 - st["total_s"]) < 1e-2 * st["calls"]


def test_the_decode_spans_name_the_route_and_the_bytes_read(tmp_path):
    stereo, mono = _wavs(tmp_path)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    with _profile():
        mt.add_tracks([0, 1], [stereo, mono])
    spans = profiling.recorded()
    want = {"stereo.wav": (2, "sum"), "mono.wav": (1, "mono")}
    files = _by_name(spans, "decode.file")
    assert sorted(f.attrs["path"] for f in files) == sorted(want)
    for f in files:
        kids = _children(spans, f)
        assert sorted(s.name for s in kids) == ["decode.mono", "decode.read"]
        (read,) = _by_name(kids, "decode.read")
        (mono_sp,) = _by_name(kids, "decode.mono")
        n_ch, route = want[f.attrs["path"]]
        assert mono_sp.attrs == {"n_ch": n_ch, "route": route}
        assert read.attrs == {
            "bytes": os.path.getsize(tmp_path / f.attrs["path"])}
    profiling.clear()
    with _profile():
        msv_tpu_torch.io.audio.open_audio_mono_ex(stereo, channel=1)
    (read,), (mono_sp,) = (_by_name(profiling.recorded(), n)
                           for n in ("decode.read", "decode.mono"))
    assert mono_sp.attrs == {"n_ch": 2, "route": "pick"}
    assert read.attrs == {"bytes": os.path.getsize(stereo)}


def test_two_identical_crops_give_two_request_trees(tmp_path):
    stereo, mono = _wavs(tmp_path)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0, 1], [stereo, mono])
    handler = type("H", (V._Handler,), {"session": mt,
                                        "lock": V._RWLock()})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.02}, daemon=True).start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}/api/spec_crop/1"
           "?px_per_sec=80&height=90&start=0.2&end=0.7")
    try:
        with _profile():
            bodies = [urllib.request.urlopen(url, timeout=60).read()
                      for _ in range(2)]
            deadline = time.time() + 30
            while (len(_by_name(profiling.recorded(), "viewer.request")) < 2
                   and time.time() < deadline):
                time.sleep(0.01)
    finally:
        srv.shutdown()
        srv.server_close()
    assert bodies[0] == bodies[1] and bodies[0][:4] == b"\x89PNG"
    spans = profiling.recorded()
    first, second = sorted(_by_name(spans, "viewer.request"),
                           key=lambda s: s.start_ns)
    assert first.parent_id is None and second.parent_id is None
    assert None not in (first.request_id, second.request_id)
    assert first.request_id != second.request_id
    for root, cache in ((first, "miss"), (second, "hit")):
        assert root.attrs == {"route": "/api/spec_crop/", "cache": cache,
                              "status": 200}
        for s in _descendants(spans, root):
            assert s.request_id == root.request_id
            assert s.thread_id == root.thread_id
    assert sorted(s.name for s in _children(spans, first)) == [
        "viewer.cache", "viewer.lock_wait", "viewer.png", "viewer.render",
        "viewer.send"]
    assert sorted(s.name for s in _children(spans, second)) == [
        "viewer.cache", "viewer.send"]
    # the session's render and the encode nest inside
    below = {s.name for s in _descendants(spans, first)}
    assert {"get_spec_image.render", "png.encode"} <= below
    (png,) = [s for s in _descendants(spans, first) if s.name == "png.encode"]
    assert png.attrs["h"] == 90 and png.attrs["w"] == 40
    assert 0 < png.attrs["bytes"] < len(bodies[0])


def test_device_trace_writes_the_spans_and_clears_them(tmp_path):
    with debug.device_trace(str(tmp_path / "trace")):
        with span("probe.outer", request=True, k="v"):
            with span("probe.inner"):
                with torch.profiler.record_function("probe.range"):
                    torch.ones(1000).sum()
    assert profiling.recorded() == []
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        doc = json.load(f)
    ev = {e["name"]: e for e in doc["traceEvents"]
          if e.get("ph") == "X" and e["name"].startswith("probe.")}
    outer, inner, rng = ev["probe.outer"], ev["probe.inner"], ev["probe.range"]
    assert outer["cat"] == inner["cat"] == "program_span"
    assert outer["args"]["k"] == "v"
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert inner["args"]["request_id"] == outer["args"]["request_id"]
    assert outer["tid"] == threading.get_native_id()
    # the profiler's own range lies inside, on the same time base (us)
    assert outer["ts"] - 1e3 <= rng["ts"]
    assert rng["ts"] + rng["dur"] <= outer["ts"] + outer["dur"] + 1e3


def test_each_mel_launch_is_a_span_under_its_group(tmp_path):
    """One ``mel.launch`` span a rate group, inside the group's
    ``add_tracks.kernel_minmax`` stage, with the launch's shape; on the CPU
    the route is the kernels' plain version: tier "plain", the launcher's
    numbers 0."""
    stereo, mono = _wavs(tmp_path)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    with _profile():
        mt.add_tracks([0, 1], [stereo, mono])
    spans = profiling.recorded()
    launches = _by_name(spans, "mel.launch")
    stages = {s.span_id: s for s in _by_name(spans,
                                             "add_tracks.kernel_minmax")}
    assert len(launches) == len(stages) >= 1
    assert sum(s.attrs["batch"] for s in launches) == 2
    for s in launches:
        assert s.parent_id in stages
        assert dict(s.attrs, batch=None) == {
            "sr": 16000, "batch": None, "win": 640, "hop": 160,
            "n_fft": 1024, "n_mel": 385, "mode": "parity", "tier": "plain",
            "mt": 0, "stages": 0, "chunk": 0, "smem_bytes": 0}


def test_streaming_records_a_mel_launch_a_segment():
    """Each streamed segment's launch is a ``mel.launch`` span with the
    caller's rate."""
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.kernels import spectrogram_cuda as K
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window
    from msv_tpu_torch.parallel.streaming import (_seg_plan_for,
                                                  streaming_spec_db)

    sr = 8000
    p = derive_stft_params(sr, SpecSetting())
    ops = K.MelRoute(default_stft_window(p.win_length, p.n_fft),
                     calc_mel_fb_default(sr, p.n_fft), win=p.win_length,
                     hop=p.hop_length, n_fft=p.n_fft, device="cpu")
    wav = np.random.default_rng(3).standard_normal(3 * sr).astype(np.float32)
    with _profile():
        db, n_frames, *_ = streaming_spec_db(
            wav, p.win_length, p.hop_length, ops, None, None,
            chunk_frames=64, seg_chunks=2, sr=sr)
    launches = _by_name(profiling.recorded(), "mel.launch")
    assert len(launches) == len(_seg_plan_for(n_frames, 64, 2)) > 1
    assert {(s.attrs["sr"], s.attrs["tier"], s.attrs["batch"])
            for s in launches} == {(sr, "plain", 1)}
