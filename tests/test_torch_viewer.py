"""The port's web viewer (``msv_tpu_torch/viewer.py``) against msv_tpu's
(``msv_tpu/viewer.py``), on the CPU: each server on an ephemeral loopback
port over its own session of the same WAVs (the port's with
``device="cpu"``), as tests/test_viewer.py's fixture does.

Every image response equals the port session's own image bit for bit, and
msv_tpu's response for the same URL within one grey level (spectrograms,
the grey8 wire; tests/test_torch_cli.py's rule), one u8 step (waveforms)
or three u8 steps (adaptive crops: their deep bins carry f32 noise through
the blend, tests/test_torch_multires.py).  Also: the error paths and
parameter bounds, Range requests, add/remove/channel/setting, the render
cache's generation rule, a query fuzz, the onsets, beats and loudness
routes, and the pitch, formants, segments, notes, key and align routes
against msv_tpu's and the direct calls, POST /api/process's derived
tracks against the library calls and /api/analyze's background report
(202, then the library report), their 400 and 404 answers, and a mirror of tests/test_viewer_contract.py on the port's page and
routes (the page is msv_tpu's, byte for byte).
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu.viewer as JV  # noqa: E402
import msv_tpu_torch  # noqa: E402
import msv_tpu_torch.viewer as V  # noqa: E402
from test_torch_cli import _tone, close_u8, cs, level_gap  # noqa: E402
from test_viewer_contract import _strip_js_literals  # noqa: E402

SPEC = "/api/spec/0?px_per_sec=50&height=100"
WAV = "/api/wav/0?px_per_sec=50&height=40"
CROP = "/api/spec_crop/0?px_per_sec=80&height=90&start=0.2&end=0.7"
WCROP = ("/api/wav_crop/0?px_per_sec=80&height=40&amp_min=-0.5&amp_max=0.5"
         "&start=0.2&end=0.7")
ACROP = "/api/adaptive_crop/0?px_per_sec=80&height=90&start=0.2&end=0.7"


def _serve(mt, handler_base, **attrs):
    lock = (V._RWLock if handler_base is V._Handler else JV._RWLock)()
    handler = type("H", (handler_base,), {"session": mt, "lock": lock,
                                          **attrs})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.02},
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def wav_path(tmp_path):
    return _tone(str(tmp_path / "a.wav"))


@pytest.fixture()
def port(wav_path):
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    srv, url = _serve(mt, V._Handler)
    yield url, mt
    srv.shutdown()


@pytest.fixture()
def ref(wav_path):
    mt = msv_tpu.MultiTrack()
    mt.add_tracks([0], [wav_path])
    srv, url = _serve(mt, JV._Handler)
    yield url, mt
    srv.shutdown()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _err(url, post=None):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, post) if post is not None else _get(url)
    return e.value.code, e.value.read()


def test_page_and_cacheable_routes_are_msv_tpu_s():
    assert V._PAGE == JV._PAGE
    assert V._CACHEABLE == JV._CACHEABLE


@pytest.mark.parametrize("path,own", [
    (SPEC, lambda mt: mt.get_spec_image(0, 50.0, 100)),
    (WAV, lambda mt: mt.get_wav_image(0, 50.0, 40, -1.0, 1.0)),
    (CROP, lambda mt: mt.get_spec_image_crop(0, 80.0, 90, 0.2, 0.7)),
    (WCROP, lambda mt: mt.get_wav_image_crop(0, 80.0, 40, -0.5, 0.5, 0.2,
                                             0.7)),
    (ACROP, lambda mt: mt.get_adaptive_spec_image_crop(0, 80.0, 90, 0.2,
                                                       0.7)),
    ("/api/colorbar?width=12&height=60",
     lambda mt: msv_tpu_torch.render.colormap.colorbar(12, 60,
                                                       device="cpu")),
])
def test_images_equal_the_session_s_and_match_jax(path, own, port, ref):
    code, body = _get(port[0] + path)
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    img = cs.png_pixels(body)
    np.testing.assert_array_equal(img, own(port[1]))
    want = cs.png_pixels(_get(ref[0] + path)[1])
    if path.startswith(("/api/spec", "/api/spec_crop")):
        assert level_gap(img, want).max() <= 1
    else:
        close_u8(img, want, steps=3 if "adaptive" in path else 1)


def test_json_routes_match_jax(port, ref):
    tracks = [json.loads(_get(u + "/api/tracks")[1]) for u in (port[0],
                                                               ref[0])]
    for key in ("max_db", "min_db"):
        assert abs(tracks[0][key] - tracks[1][key]) <= 2e-3 + 1e-4 * abs(
            tracks[1][key])
        del tracks[0][key], tracks[1][key]
    assert tracks[0] == tracks[1]
    for path in ("/api/setting", "/api/freq/0?rel=0.37",
                 "/api/freq/0?rel=0.5&mel=1"):
        assert _get(port[0] + path)[1] == _get(ref[0] + path)[1], path
    assert _get(port[0] + "/api/colormap") == _get(ref[0] + "/api/colormap")
    code, body = _get(port[0] + "/")
    assert code == 200 and body == _get(ref[0] + "/")[1]


def test_stats(port):
    _get(port[0] + CROP)
    d = json.loads(_get(port[0] + "/api/stats")[1])
    assert d["tracks"] == 1 and d["sr_cache"] == [8000]
    assert d["hbm"] == json.loads(json.dumps(port[1].hbm_stats()))
    assert d["render_cache"]["misses"] >= 1 and d["adaptive_builds"] == {}
    assert "get_spec_image.render" in d["stage_timings"]


def test_error_paths(port):
    assert _err(port[0] + "/api/spec/99?px_per_sec=50&height=100")[0] == 500
    assert _err(port[0] + "/nope")[0] == 404
    for path in ("/api/audio/99", "/api/spec_crop/99?px_per_sec=50"
                 "&height=100&start=0&end=0.1", "/api/freq/99?rel=0.5"):
        code, body = _err(port[0] + path)
        assert code == 500 and b"track 99 not found" in body, path
    assert _err(port[0] + "/api/nope", post={})[0] == 404


def test_param_bounds(port):
    for path in [
        "/api/spec/0?px_per_sec=10000000&height=100",
        "/api/spec/0?px_per_sec=nan&height=100",
        "/api/spec_crop/0?px_per_sec=50&height=100&start=-5&end=1",
        "/api/spec_crop/0?px_per_sec=50&height=100&start=0&end=1e9",
        "/api/wav/0?px_per_sec=50&height=40&amp_min=-inf&amp_max=1",
        "/api/wav/0?px_per_sec=50&height=-1",
    ]:
        assert _err(port[0] + path)[0] == 500, path
    assert _get(port[0] + SPEC)[0] == 200


def test_audio_and_range_requests_match_jax(port, ref):
    code, full = _get(port[0] + "/api/audio/0")
    assert code == 200 and full == _get(ref[0] + "/api/audio/0")[1]
    total = len(full)

    def get_range(spec):
        req = urllib.request.Request(port[0] + "/api/audio/0",
                                     headers={"Range": f"bytes={spec}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Range"), r.read()

    st, cr, body = get_range("13-4095")
    assert st == 206 and body == full[13:4096]
    assert cr == f"bytes 13-4095/{total}"
    st, cr, body = get_range(f"{total - 999}-")
    assert st == 206 and body == full[-999:]
    st, cr, body = get_range("-500")
    assert st == 206 and body == full[-500:]
    assert get_range("0-43")[2] == full[:44]
    assert _get(port[0] + "/api/audio/0", {"Range": "bytes=abc"}) == (200,
                                                                      full)
    assert _err_range(port[0], f"{total + 5}-{total + 9}") == 416


def _err_range(url, spec):
    req = urllib.request.Request(url + "/api/audio/0",
                                 headers={"Range": f"bytes={spec}"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value.code


def test_add_channel_remove(port, tmp_path):
    url, mt = port
    st = _tone(str(tmp_path / "st.wav"), channels=2)
    assert _post(url + "/api/add", {"id": 5, "path": st})[1]["ok"]
    d = json.loads(_get(url + "/api/tracks")[1])
    assert [t["id"] for t in d["tracks"]] == [0, 5]
    assert d["tracks"][1]["n_channels"] == 2
    assert d["tracks"][1]["channel"] is None
    assert _post(url + "/api/channel", {"id": 5, "channel": 1})[1]["ok"]
    direct = msv_tpu_torch.MultiTrack(device="cpu")
    direct.add_tracks([0, 5], [mt.get_path(0), st], channels=[None, 1])
    np.testing.assert_array_equal(
        cs.png_pixels(_get(url + WAV.replace("/0?", "/5?"))[1]),
        direct.get_wav_image(5, 50.0, 40, -1.0, 1.0))
    assert _err(url + "/api/channel", post={"id": 5, "channel": 2})[0] == 500
    assert _post(url + "/api/remove", {"id": 5})[1]["ok"]
    assert [t["id"] for t in json.loads(_get(url + "/api/tracks")[1])
            ["tracks"]] == [0]
    assert _err(url + "/api/add", post={"id": 6, "path": "/nope.wav"})[0] \
        == 500
    assert _err(url + "/api/remove", post={"id": 99})[0] == 500


def test_setting_round_trip_equals_the_session(port):
    url, mt = port
    direct = msv_tpu_torch.MultiTrack(device="cpu")
    direct.add_tracks([0], [mt.get_path(0)])
    for scale in ("linear", "mel"):
        assert _post(url + "/api/setting", {"freq_scale": scale})[1]["ok"]
        direct.set_setting(msv_tpu_torch.SpecSetting(
            freq_scale=msv_tpu_torch.FreqScale(scale)))
        s = json.loads(_get(url + "/api/setting")[1])
        assert s["freq_scale"] == scale and s["db_range"] == 120.0
        for path, fn in ((SPEC, lambda m: m.get_spec_image(0, 50.0, 100)),
                         (CROP, lambda m: m.get_spec_image_crop(
                             0, 80.0, 90, 0.2, 0.7))):
            np.testing.assert_array_equal(
                cs.png_pixels(_get(url + path)[1]), fn(direct))
    _post(url + "/api/setting", {"win_ms": 25.0, "t_overlap": 2})
    s = json.loads(_get(url + "/api/setting")[1])
    assert s["win_ms"] == 25.0 and s["t_overlap"] == 2
    assert _err(url + "/api/setting", post={"t_overlap": 0})[0] == 500


def test_render_cache_generation_rule(wav_path, monkeypatch):
    """Identical requests render once; a mutation bumps the generation, so
    the same URL renders fresh (VERDICT r3 #5's rule)."""
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    calls = {"spec_crop": 0}
    real = mt.get_spec_image_crop

    def counting(*a, **k):
        calls["spec_crop"] += 1
        return real(*a, **k)

    monkeypatch.setattr(mt, "get_spec_image_crop", counting)
    srv, url = _serve(mt, V._Handler)
    try:
        bodies = [_get(url + CROP)[1] for _ in range(3)]
        assert calls["spec_crop"] == 1 and bodies[0] == bodies[1] == \
            bodies[2]
        _get(url + CROP.replace("end=0.7", "end=0.8"))
        assert calls["spec_crop"] == 2
        st = json.loads(_get(url + "/api/stats")[1])["render_cache"]
        assert st["hits"] == 2 and st["misses"] == 2
        gen0 = json.loads(_get(url + "/api/tracks")[1])["gen"]
        _post(url + "/api/setting", {"win_ms": 25.0})
        _get(url + CROP)
        assert calls["spec_crop"] == 3
        assert json.loads(_get(url + "/api/tracks")[1])["gen"] > gen0
    finally:
        srv.shutdown()
    c = V._RenderCache()
    g = c.gen
    c.bump_gen()  # a mutation lands while a render was in flight
    c.put("/api/spec/0", "image/png", b"stale", gen=g)
    assert c.get("/api/spec/0") is None
    c.put("/api/spec/0", "image/png", b"fresh", gen=c.gen)
    assert c.get("/api/spec/0") == ("image/png", b"fresh")


def _library_outputs(op, wav, sr, body):
    """What POST /api/process adds for ``op``: the library call's
    outputs, loudest part first for ``separate``."""
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.ops.declick import declick
    from msv_tpu_torch.ops.denoise import denoise
    from msv_tpu_torch.ops.hpss import hpss
    from msv_tpu_torch.ops.nmf import separate
    from msv_tpu_torch.ops.specedit import Box, spectral_edit

    p = derive_stft_params(sr, SpecSetting())
    stft, cpu = (p.win_length, p.hop_length, p.n_fft), {"device": "cpu"}
    if op == "declick":
        return [declick(wav, sr, **cpu)[0]]
    if op == "denoise":
        return [denoise(wav, *stft, sr=sr, **cpu)]
    if op in ("harmonic", "percussive"):
        return [hpss(wav, *stft, **cpu)[op == "percussive"]]
    if op == "separate":
        parts = separate(wav, *stft, n_components=body["components"],
                         **cpu)[0]
        return list(parts[np.argsort(-(parts ** 2).sum(axis=1))])
    return [spectral_edit(wav, sr, [Box(**b) for b in body["boxes"]],
                          win_length=p.win_length, hop_length=p.hop_length,
                          n_fft=p.n_fft, **cpu)]


PROCESS = {
    "denoise": {}, "declick": {}, "harmonic": {}, "percussive": {},
    "separate": {"components": 2},
    "specedit": {"boxes": [{"t0": 0.1, "t1": 0.3, "f0": 300, "f1": 900,
                            "gain_db": -30.0},
                           {"t0": 0.5, "t1": 0.52, "f0": 0, "f1": 4000,
                            "mode": "patch"}]},
}


@pytest.mark.parametrize("op", sorted(PROCESS))
def test_process_adds_the_library_call_s_track(op, port):
    url, mt = port
    body = {"id": 0, "op": op, **PROCESS[op]}
    gen = json.loads(_get(url + "/api/tracks")[1])["gen"]
    code, resp = _post(url + "/api/process", body)
    want = _library_outputs(op, mt._track(0).wav_slice(
        0, mt._track(0).n_samples), mt.get_sr(0), body)
    assert code == 200 and resp["ok"] and resp["op"] == op
    assert resp["source"] == 0 and resp["ids"] == list(
        range(1, 1 + len(want))) and resp["id"] == 1
    for new_id, y in zip(resp["ids"], want):
        tr = mt._track(new_id)
        np.testing.assert_array_equal(tr.wav_slice(0, tr.n_samples), y)
        code, img = _get(url + f"/api/spec_crop/{new_id}?px_per_sec=80"
                         "&height=90&start=0.2&end=0.7")
        assert code == 200 and np.array_equal(
            cs.png_pixels(img), mt.get_spec_image_crop(new_id, 80.0, 90,
                                                       0.2, 0.7))
    assert json.loads(_get(url + "/api/tracks")[1])["gen"] > gen


@pytest.mark.parametrize("body,code", [
    ({"id": 0, "op": "hpss"}, 400),  # msv_tpu's op names are the parts
    ({"op": "denoise"}, 400),
    ({"id": 7, "op": "denoise"}, 404),
    ({"id": 0, "op": "separate", "components": 9}, 400),
    ({"id": 0, "op": "specedit", "boxes": [{"t0": 0.1}]}, 400),
    ({"id": 0, "op": "separate", "new_id": 5}, 400),
    ({"id": 0, "op": "denoise", "new_id": 0}, 400),
])
def test_process_refuses_bad_requests(body, code, port):
    got, text = _err(port[0] + "/api/process", post=body)
    assert got == code and text.startswith(b"error:")
    assert sorted(port[1].tracks) == [0]


def test_analyze_is_pending_then_the_library_report(port):
    from msv_tpu_torch.features import analyze

    url, mt = port
    code, body = _get(url + "/api/analyze/0")
    assert code == 202 and json.loads(body) == {"pending": True}
    t0 = time.time()
    while code == 202:
        assert time.time() - t0 < 120
        time.sleep(0.05)
        code, body = _get(url + "/api/analyze/0")
    tr = mt._track(0)
    want = dict(analyze(tr.wav_slice(0, tr.n_samples), tr.sr,
                        device="cpu"),
                window_s=round(tr.n_samples / tr.sr, 3))
    assert code == 200 and json.loads(body) == json.loads(json.dumps(want))
    got, text = _err(url + "/api/analyze/9")
    assert got == 404 and text.startswith(b"error:")


@pytest.fixture()
def clicks(tmp_path):
    """Both viewers over one 6 s click-train WAV (16 kHz stereo)."""
    from test_torch_cli import _clicks

    path = _clicks(str(tmp_path / "c.wav"))
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [path])
    jmt = msv_tpu.MultiTrack()
    jmt.add_tracks([0], [path])
    srv, url = _serve(mt, V._Handler)
    jsrv, jurl = _serve(jmt, JV._Handler)
    yield url, jurl, mt
    srv.shutdown()
    jsrv.shutdown()


def test_onsets_beats_and_loudness_routes_match_jax(clicks):
    """Each response equals the direct library call on the same slice and
    msv_tpu's response (onset and beat times equal; the loudness summary
    within its rounding: 0.01 LU / dB, LRA 0.1 LU); a second request is a
    cache hit."""
    from msv_tpu_torch.features import onset_detect
    from msv_tpu_torch.ops.loudness import r128_stats
    from msv_tpu_torch.ops.rhythm import beat_track

    url, jurl, mt = clicks
    tr = mt._track(0)
    a, b = int(1.0 * tr.sr), int(5.5 * tr.sr)
    wav = tr.wav_slice(a, b)
    times = onset_detect(wav, tr.sr, device="cpu")
    bpm, beats = beat_track(wav, tr.sr, device="cpu")
    cases = {
        "/api/onsets/0?start=1&end=5.5": {
            "t": [round(1.0 + float(v), 3) for v in times]},
        "/api/beats/0?start=1&end=5.5": {
            "bpm": round(float(bpm), 1),
            "t": [round(1.0 + float(v), 3) for v in beats]},
        "/api/loudness/0": r128_stats(tr.wav_slice(0, tr.n_samples), tr.sr,
                                      device="cpu"),
    }
    for path, direct in cases.items():
        got = json.loads(_get(url + path)[1])
        assert got == json.loads(json.dumps(direct)), path
        want = json.loads(_get(jurl + path)[1])
        if "loudness" in path:
            for key, tol in (("lufs", 0.01), ("lra", 0.1), ("dbtp", 0.01)):
                assert abs(got[key] - want[key]) <= tol + 1e-9, key
        else:
            assert got == want, path
    assert len(cases["/api/onsets/0?start=1&end=5.5"]["t"]) >= 5
    assert cases["/api/beats/0?start=1&end=5.5"]["bpm"] == 120.0
    hits = json.loads(_get(url + "/api/stats")[1])["render_cache"]["hits"]
    for path in cases:
        _get(url + path)
    stats = json.loads(_get(url + "/api/stats")[1])["render_cache"]
    assert stats["hits"] == hits + len(cases)
    # short windows answer empty, as msv_tpu's do
    for path in ("/api/onsets/0?start=0&end=0.05",
                 "/api/beats/0?start=0&end=0.5"):
        assert _get(url + path)[1] == _get(jurl + path)[1]


def _song(path, sr=16000):
    """4 s of notes (a gapped melody over a quiet noise floor), then 4 s of
    noise: pitch, formants, notes, key and one structure boundary."""
    from msv_tpu_torch.io.audio import write_wav

    rng = np.random.default_rng(9)
    t = np.arange(int(0.6 * sr)) / sr
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
    parts = []
    for f in (261.63, 329.63, 392.0, 523.25, 392.0, 329.63):
        parts += [0.4 * env * np.sin(2 * np.pi * f * t),
                  np.zeros(int(0.066 * sr))]
    x = np.concatenate(parts)[:4 * sr]
    x = np.concatenate([x, np.zeros(4 * sr - len(x)),
                        0.2 * rng.standard_normal(4 * sr)])
    x = x + 0.002 * rng.standard_normal(len(x))
    write_wav(path, x.astype(np.float32)[None], sr)
    late = np.concatenate([np.zeros(int(0.5 * sr)), x])
    write_wav(path[:-4] + "_late.wav", late.astype(np.float32)[None], sr)
    return path, path[:-4] + "_late.wav"


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """Both viewers over the song (track 0) and its copy 0.5 s later
    (track 1)."""
    d = tmp_path_factory.mktemp("songs")
    paths = list(_song(str(d / "song.wav")))
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0, 1], paths)
    jmt = msv_tpu.MultiTrack()
    jmt.add_tracks([0, 1], paths)
    srv, url = _serve(mt, V._Handler)
    jsrv, jurl = _serve(jmt, JV._Handler)
    yield url, jurl, mt
    srv.shutdown()
    jsrv.shutdown()


def _direct(route, mt, query):
    """The response body of ``route`` from the port's library calls, as the
    viewer computes it (its window rules, rounding and display mapping)."""
    from msv_tpu_torch.ops.align import align_offset
    from msv_tpu_torch.ops.lpc import formant_track
    from msv_tpu_torch.ops.mel import hz_to_mel
    from msv_tpu_torch.ops.pitch import yin
    from msv_tpu_torch.ops.segment import segment
    from msv_tpu_torch.ops.sequence import smooth_f0_viterbi
    from msv_tpu_torch.ops.tonal import estimate_key
    from msv_tpu_torch.ops.transcribe import transcribe_notes

    tr = mt._track(0)
    sr = tr.sr
    s0, s1 = float(query.get("start", 0.0)), float(query.get("end", 8.0))
    a, b = int(s0 * sr), min(tr.n_samples, int(s1 * sr))
    wav = tr.wav_slice(a, b)
    half = np.float32(sr) / np.float32(2.0)

    def rel(hz):
        return np.asarray(hz_to_mel(np.asarray(hz, np.float32))) / float(
            hz_to_mel(half))

    if route == "pitch":
        f0, ap = (v.numpy() for v in yin(wav, sr, fmax=min(
            2093.0, sr / 2 * 0.99), with_aperiodicity=True, device="cpu"))
        if query.get("smooth") == "1":
            f0, voiced = smooth_f0_viterbi(f0, ap, fmax=min(
                2093.0, sr / 2 * 0.99), device="cpu")
            ap = np.where(voiced, 0.0, 1.0).astype(np.float32)
        return {"t0": a / sr, "hop_s": 512 / sr,
                "f0": [round(float(v), 2) for v in f0],
                "ap": [round(float(v), 3) for v in ap],
                "rel": [round(float(v), 4) for v in rel(f0)]}
    if route == "formants":
        f, hop_s, _ = formant_track(wav, sr, n_formants=4,
                                    fmax=min(5500.0, sr / 2.0), device="cpu")
        f = f.numpy()
        r = rel(f)
        ok = np.isfinite(f)
        return {"t0": a / sr, "hop_s": hop_s,
                "f": [[round(float(v), 1) if o else None for v, o in
                       zip(row, okr)] for row, okr in zip(f, ok)],
                "rel": [[round(float(v), 4) if o else None for v, o in
                         zip(row, okr)] for row, okr in zip(r, ok)]}
    if route == "segments":
        ks = max(1.5, min(8.0, len(wav) / sr / 4.0))
        return {"t": [round(a / sr + float(v), 3) for v in segment(
            wav, sr, hop_s=0.5, kernel_s=ks, device="cpu")]}
    if route == "notes":
        notes = transcribe_notes(wav, sr, fmax=min(2093.0, sr / 2 * 0.99),
                                 device="cpu")
        for nt in notes:
            nt["start"] = round(nt["start"] + a / sr, 6)
            nt["end"] = round(nt["end"] + a / sr, 6)
            nt["rel"] = round(float(rel(nt["hz"])), 4)
        return {"notes": notes}
    if route == "key":
        tonic, mode, r, _ = estimate_key(tr.wav_slice(0, tr.n_samples), sr,
                                         device="cpu")
        return {"tonic": tonic, "mode": mode,
                "r": None if tonic is None else round(r, 3)}
    late = mt._track(1)
    r = align_offset(tr.wav_slice(0, tr.n_samples), sr,
                     late.wav_slice(0, late.n_samples), late.sr,
                     max_lag_s=float(query["max_lag"]), device="cpu")
    return {"ref": 0, "id": 1, "offset_s": round(r.offset_s, 6),
            "confidence": round(r.confidence, 4),
            "coarse_s": round(r.coarse_s, 4)}


ANALYSIS_2 = {
    "pitch": "/api/pitch/0?start=0&end=4",
    "pitch_smooth": "/api/pitch/0?start=0&end=4&smooth=1",
    "formants": "/api/formants/0?start=0.5&end=2.5",
    "segments": "/api/segments/0",
    "notes": "/api/notes/0?start=0&end=4",
    "key": "/api/key/0",
    "align": "/api/align/1?ref=0&max_lag=2",
}


@pytest.mark.parametrize("name", sorted(ANALYSIS_2))
def test_analysis_2_routes_equal_the_direct_calls(name, songs):
    """Each response equals the port's library calls on the same slice;
    a second request is a cache hit; msv_tpu's response names the same
    notes, key, boundaries and voicing (pitch within tests/
    test_pitch.py's rtol 5e-3, formants within one 5.4 Hz grid step, the
    key's r within 1e-2 in the route's default fast precision)."""
    url, jurl, mt = songs
    path = ANALYSIS_2[name]
    query = dict(kv.split("=") for kv in path.partition("?")[2].split("&")
                 if kv)
    got = json.loads(_get(url + path)[1])
    assert got == json.loads(json.dumps(_direct(name.split("_")[0], mt,
                                                query)))
    hits = json.loads(_get(url + "/api/stats")[1])["render_cache"]["hits"]
    assert json.loads(_get(url + path)[1]) == got
    assert json.loads(_get(url + "/api/stats")[1])["render_cache"][
        "hits"] == hits + 1
    if name == "align":  # pinned to msv_tpu by tests/test_torch_align.py
        assert abs(got["offset_s"] - 0.5) < 1e-3
        return
    want = json.loads(_get(jurl + path)[1])
    assert got.keys() == want.keys()
    if name.startswith("pitch"):
        assert got["t0"] == want["t0"] and got["hop_s"] == want["hop_s"]
        np.testing.assert_allclose(got["f0"], want["f0"], rtol=5e-3)
        if name == "pitch_smooth":
            assert got["ap"] == want["ap"] and got["f0"] == want["f0"]
    elif name == "formants":
        g, w = (np.array([[np.nan if v is None else v for v in row]
                          for row in d["f"]]) for d in (got, want))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 5500.0 / 1023 + 0.1
    elif name == "key":
        # the route's default precision is fast: the port rounds the chroma
        # GEMM's operands to bf16, msv_tpu's CPU run is f32 (r moved 2e-3)
        assert (got["tonic"], got["mode"]) == (want["tonic"], want["mode"])
        assert abs(got["r"] - want["r"]) <= 1e-2
    else:
        assert got == want
    if name == "segments":
        assert len(got["t"]) == 1 and abs(got["t"][0] - 4.0) <= 1.0
    if name == "notes":
        assert [n["midi"] for n in got["notes"]] == [60, 64, 67, 72, 67, 64]


@pytest.mark.parametrize("path, status", [
    ("/api/pitch/0?fmin=4000&fmax=3000", 400),  # fmin over the search band
    ("/api/pitch/0?fmin=nan", 400),
    ("/api/pitch/x", 400),
    ("/api/formants/0?n=9", 400),
    ("/api/notes/0?fmax=1e9", 400),
    ("/api/segments/0?start=-1", 400),
    ("/api/align/1?ref=0&max_lag=0", 400),
    ("/api/align/1?ref=7", 404),
    ("/api/key/9", 404),
])
def test_analysis_2_routes_refuse_bad_parameters(path, status, songs):
    """A bad parameter answers 400 and an unknown track 404, with an
    ``error:`` body (msv_tpu answers 500 to both), and the server keeps
    serving."""
    url, jurl, _ = songs
    code, body = _err(url + path)
    assert code == status and body.startswith(b"error:")
    assert _err(jurl + path)[0] == 500
    assert _get(url + "/api/key/0")[0] == 200


def test_query_fuzz_never_kills_the_server(port, rng):
    paths = ["/api/spec_crop/0", "/api/wav_crop/0", "/api/adaptive_crop/0",
             "/api/freq/0", "/api/spec/0", "/api/wav/0", "/api/audio/0",
             "/api/tracks", "/api/colorbar", "/api/pitch/0", "/api/nope/9"]
    keys = ["px_per_sec", "height", "start", "end", "rel", "amp_min",
            "amp_max", "mel", "width", "junk"]
    for _ in range(60):
        q = "&".join(
            f"{keys[int(rng.integers(0, len(keys)))]}="
            f"{['-1', '1e30', 'nan', 'abc', '0', str(rng.normal())][int(rng.integers(0, 6))]}"  # noqa: E501
            for _ in range(int(rng.integers(0, 4))))
        url = port[0] + paths[int(rng.integers(0, len(paths)))] + (
            "?" + q if q else "")
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                r.read(64)
        except urllib.error.HTTPError as e:
            assert 400 <= e.code < 600
    code, body = _get(port[0] + "/api/spec_crop/0?px_per_sec=50&height=60"
                      "&start=0&end=1")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"


def test_adaptive_202_then_200(wav_path, monkeypatch):
    """A zoomed-out adaptive crop whose background build has not covered
    the viewport answers 202 + progress; polling converges to the PNG."""
    from msv_tpu_torch.ops.multires import (adaptive_auto_n_mel,
                                            adaptive_frame_count)
    from msv_tpu_torch.session.multitrack import MultiTrack, _AdaptiveBuild

    mt = MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    monkeypatch.setattr(MultiTrack, "ADAPTIVE_MAX_FRAMES", 32)
    monkeypatch.setattr(MultiTrack, "ADAPTIVE_CHUNK", 64)
    srv, url = _serve(mt, V._Handler)
    path = url + "/api/adaptive_crop/0?px_per_sec=30&height=60&start=0&end=1"
    try:
        tr = mt.tracks[0]
        nf = adaptive_frame_count(tr.n_samples, tr.sr, mt.setting)
        mt._adaptive_db[0] = _AdaptiveBuild(
            adaptive_auto_n_mel(tr.sr, mt.setting), nf)
        with urllib.request.urlopen(path, timeout=30) as r:
            assert r.status == 202
            assert json.loads(r.read()) == {"pending": True, "built": 0,
                                            "total": nf}
        st = json.loads(_get(url + "/api/stats")[1])
        assert st["adaptive_builds"] == {"0": {"built": 0, "total": nf}}
        mt._drop_adaptive(0)
        deadline, png = time.time() + 60, None
        while time.time() < deadline and png is None:
            with urllib.request.urlopen(path, timeout=30) as r:
                if r.status == 200:
                    png = r.read()
            time.sleep(0.05)
        assert png is not None
        monkeypatch.setattr(MultiTrack, "ADAPTIVE_MAX_FRAMES", 1 << 16)
        np.testing.assert_array_equal(
            cs.png_pixels(png),
            mt.get_adaptive_spec_image_crop(0, 30.0, 60, 0.0, 1.0))
    finally:
        srv.shutdown()


def test_add_root_restriction(tmp_path):
    allowed = tmp_path / "allowed"
    allowed.mkdir()
    inside = _tone(str(allowed / "in.wav"))
    outside = _tone(str(tmp_path / "out.wav"))
    srv, url = _serve(msv_tpu_torch.MultiTrack(device="cpu"), V._Handler,
                      add_root=str(allowed))
    try:
        assert _post(url + "/api/add", {"id": 0, "path": inside})[0] == 200
        assert _err(url + "/api/add", post={"id": 1, "path": outside})[0] \
            == 403
        assert _err(url + "/api/add", post={
            "id": 2, "path": str(allowed / ".." / "out.wav")})[0] == 403
    finally:
        srv.shutdown()


def test_concurrent_renders_and_mutation(port, tmp_path):
    """Renders run concurrently under the read lock and stay equal to the
    session's images while an add (the write lock) interleaves."""
    import concurrent.futures

    url, mt = port
    p2 = _tone(str(tmp_path / "c.wav"), seed=11)
    want = {i: mt.get_spec_image(0, 40.0 + i, 60) for i in range(8)}

    def render(i):
        img = cs.png_pixels(_get(url + f"/api/spec/0?px_per_sec={40 + i}"
                                       f"&height=60")[1])
        assert _get(url + f"/api/adaptive_crop/0?px_per_sec={40 + i}"
                          f"&height=50&start=0.1&end=0.9")[0] == 200
        return img.shape == want[i].shape

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        renders = [ex.submit(render, i) for i in range(8)]
        adder = ex.submit(_post, url + "/api/add", {"id": 7, "path": p2})
        assert all(f.result(timeout=60) for f in renders)
        assert adder.result(timeout=60)[0] == 200
    assert {t["id"] for t in json.loads(_get(url + "/api/tracks")[1])
            ["tracks"]} == {0, 7}
    np.testing.assert_array_equal(
        cs.png_pixels(_get(url + "/api/spec/7?px_per_sec=50&height=60")[1]),
        mt.get_spec_image(7, 50.0, 60))


def test_serve_viewer_binds_first_and_loads_in_the_background(wav_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=V.serve_viewer, args=([wav_path], port),
                     kwargs={"device": "cpu"}, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    deadline, d = time.time() + 60, None
    while time.time() < deadline:
        try:
            d = json.loads(_get(base + "/api/tracks")[1])
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
            continue
        if d.get("tracks"):
            break
        assert d.get("loading") is True
        time.sleep(0.1)
    assert d and d["tracks"][0]["sr"] == 8000
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    np.testing.assert_array_equal(
        cs.png_pixels(_get(base + WCROP)[1]),
        mt.get_wav_image_crop(0, 80.0, 40, -0.5, 0.5, 0.2, 0.7))


def test_serve_viewer_without_a_card_raises(wav_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.serve_viewer([wav_path], 0)


# ------------------------------------- the client <-> server contract


CLIENT_EXEMPT = {"/api/spec", "/api/wav", "/api/colormap", "/api/stats"}


def _client_endpoints():
    eps = {m.group(0) for m in re.finditer(r"/api/[a-z_]+", V._PAGE)}
    eps.discard("/api/")
    for m in re.finditer(r"/api/\$\{(\w+)\}", V._PAGE):
        for d in re.finditer(rf"(?:const|let|var)\s+{m.group(1)}\s*=([^;]*);",
                             V._PAGE):
            for q in re.finditer(r"'([a-z_]+)'", d.group(1)):
                eps.add("/api/" + q.group(1))
    return eps


def _server_routes():
    """Routes do_GET / do_POST serve."""
    import inspect

    src = (inspect.getsource(V._Handler.do_GET)
           + inspect.getsource(V._Handler.do_POST))
    pat = r'url\.path(?:\s*==\s*|\.startswith\()\s*"(/api/[a-z_]+)'
    return {m.group(1).rstrip("/") for m in re.finditer(pat, src)}


def test_every_client_endpoint_has_a_server_route():
    client = _client_endpoints()
    assert client and not sorted(client - _server_routes())


def test_every_server_route_is_used_or_exempted():
    client, server = _client_endpoints(), _server_routes()
    assert not sorted(server - client - CLIENT_EXEMPT)
    assert not sorted(CLIENT_EXEMPT - server)
    assert not sorted(CLIENT_EXEMPT & client)


def test_cacheable_prefixes_are_real_routes():
    server = _server_routes()
    for prefix in V._CACHEABLE:
        assert prefix.rstrip("/") in server, prefix


def test_not_ported_routes_are_the_analysis_routes():
    """Every msv_tpu route is served (the last two, /api/analyze and POST
    /api/process, since their operations were ported): no route answers
    "not ported"."""
    import inspect

    src = (inspect.getsource(JV._Handler.do_GET)
           + inspect.getsource(JV._Handler.do_POST))
    pat = r'url\.path(?:\s*==\s*|\.startswith\()\s*"(/api/[a-z_]+)'
    jax_routes = {m.group(1).rstrip("/") for m in re.finditer(pat, src)}
    assert jax_routes == _server_routes()
    assert {"/api/analyze", "/api/process"} <= _server_routes()
    assert not [n for n in vars(V._Handler) if "not_ported" in n.lower()]


def test_client_script_brackets_balance():
    m = re.search(r"<script>(.*)</script>", V._PAGE, re.S)
    code = _strip_js_literals(m.group(1))
    pairs = {")": "(", "]": "[", "}": "{"}
    stack = []
    for ch in code:
        if ch in "([{":
            stack.append(ch)
        elif ch in ")]}":
            assert stack and stack.pop() == pairs[ch]
    assert not stack
