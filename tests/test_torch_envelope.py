"""The port's waveform envelope renderer (``render/envelope.py``) and the
session's waveform images against the JAX package.

Pixel rows are integers and every reduction is an exact min/max, so the
port must equal msv_tpu exactly, on every path: direct, pooled, sparse
(cached and uncached), the deep-zoom upsample quirk and its viewport form,
windows built past ``_COLW_FULL_LIMIT``, tall images, a buffer adopted
from streaming, and the session's ``get_wav_image`` / ``_crop``.
Inputs are made with numpy from seeds.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.io.audio import write_wav  # noqa: E402
from msv_tpu.render import envelope as jenv  # noqa: E402
from msv_tpu_torch.render import envelope as tenv  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402


def _both(wav, nwidth, nheight, amp, col_range=None, mode=None,
          monkeypatch=None):
    """(port, JAX) images of ``wav``, with ``_FORCE_MODE`` patched the same
    in both modules."""
    if monkeypatch is not None:
        for mod in (tenv, jenv):
            monkeypatch.setattr(mod, "_FORCE_MODE", mode)
    got = tenv.wav_to_image(wav, nwidth, nheight, amp, col_range=col_range,
                            device="cpu")
    want = jenv.wav_to_image(wav, nwidth, nheight, amp, col_range=col_range)
    return got, want


@pytest.mark.parametrize("name", ["column_windows",
                                  "_upsample_reference_quirk",
                                  "_upsample_quirk_range", "_paint_envelope"])
def test_host_helpers_are_verbatim_copies(name):
    assert (inspect.getsource(getattr(tenv, name))
            == inspect.getsource(getattr(jenv, name)))
    for const in ("_COL_BUCKET", "_CHUNK", "_BLOCK", "_DIRECT_LIMIT",
                  "_WAV_BUCKET", "_COLW_FULL_LIMIT", "_PAINT_CHUNK_PX"):
        assert getattr(tenv, const) == getattr(jenv, const)


@pytest.mark.parametrize("n,nwidth,nheight", [
    (4800, 100, 50),    # spp 48: direct
    (4800, 480, 120),   # spp 10
    (100, 300, 60),     # spp < 1: the upsample quirk
    (5000, 4999, 40),   # spp ~ 1
    (200_000, 40, 64),  # spp 5000: pooled
])
def test_wav_to_image_equals_jax(n, nwidth, nheight, rng):
    wav = (0.8 * np.sin(np.linspace(0, 60, n)) * rng.random(n)).astype(
        np.float32)
    got, want = _both(wav, nwidth, nheight, (-1.0, 1.0))
    assert got.shape == (nheight, nwidth, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["direct", "sparse"])
def test_forced_paths_equal_jax(mode, rng, monkeypatch):
    wav = rng.standard_normal(50000).astype(np.float32)
    wav[1000:1200] = 0.5  # ties
    for nw, nh in [(700, 90), (123, 40), (2048, 64), (37, 120)]:
        got, want = _both(wav, nw, nh, (-3.0, 3.0), mode=mode,
                          monkeypatch=monkeypatch)
        np.testing.assert_array_equal(got, want, err_msg=f"{nw}x{nh}")


def test_pooled_equals_forced_direct(rng, monkeypatch):
    wav = rng.standard_normal(200_000).astype(np.float32)
    pooled = tenv.wav_to_image(wav, 40, 64, (-3.0, 3.0), device="cpu")
    monkeypatch.setattr(tenv, "_FORCE_MODE", "direct")
    monkeypatch.setattr(tenv, "_DIRECT_LIMIT", 10**9)
    direct = tenv.wav_to_image(wav, 40, 64, (-3.0, 3.0), device="cpu")
    np.testing.assert_array_equal(pooled, direct)


@pytest.mark.parametrize("mode", ["direct", "sparse"])
def test_state_paths_equal_jax_int16(mode, rng, monkeypatch):
    """Cached sparse levels (rendered twice), cached column windows and an
    amp-only re-render, from an int16 carrier."""
    wav = (rng.standard_normal(50000) * 8000).astype(np.int16)
    wav[2000:2200] = 31000  # a spike + ties
    for mod in (tenv, jenv):
        monkeypatch.setattr(mod, "_FORCE_MODE", mode)
    st_t = tenv.EnvelopeState(None, wav, n=len(wav), device="cpu")
    st_j = jenv.EnvelopeState(None, wav, n=len(wav))
    for amp in [(-1.2, 1.2), (-1.2, 1.2), (-2.0, 2.0)]:
        for nw, nh in [(700, 90), (123, 40), (2048, 64)]:
            got = tenv.wav_to_image(None, nw, nh, amp, state=st_t)
            want = jenv.wav_to_image(None, nw, nh, amp, state=st_j)
            np.testing.assert_array_equal(got, want, err_msg=f"{nw} {amp}")
    if mode == "sparse":
        assert len(st_t._sparse_cache) > 0
    assert len(st_t._dev_col_cache) > 0


def test_pooled_state_and_crops_equal_jax(rng):
    wav = (rng.standard_normal(300_000) * 6000).astype(np.int16)
    st_t = tenv.EnvelopeState(None, wav, n=len(wav), device="cpu")
    st_j = jenv.EnvelopeState(None, wav, n=len(wav))
    for nw, cr in [(60, None), (60, (10, 33)), (2000, (1500, 1999))]:
        got = tenv.wav_to_image(None, nw, 80, (-1.0, 1.0), state=st_t,
                                col_range=cr)
        want = jenv.wav_to_image(None, nw, 80, (-1.0, 1.0), state=st_j,
                                 col_range=cr)
        np.testing.assert_array_equal(got, want, err_msg=f"{nw} {cr}")
    assert st_t._pooled is not None


def test_deep_zoom_crops_equal_jax_and_stay_viewport_local(rng):
    wav_i = (rng.standard_normal(5000) * 8000).astype(np.int16)
    st_t = tenv.EnvelopeState(None, wav_i, n=5000, device="cpu")
    st_j = jenv.EnvelopeState(None, wav_i, n=5000)
    nwidth = 20000  # spp 0.25, upsample factor 4
    for c0, c1 in [(0, 300), (7000, 7450), (19500, 20000), (123, 124)]:
        got = tenv.wav_to_image(None, nwidth, 60, (-1.0, 1.0), state=st_t,
                                col_range=(c0, c1))
        want = jenv.wav_to_image(None, nwidth, 60, (-1.0, 1.0), state=st_j,
                                 col_range=(c0, c1))
        np.testing.assert_array_equal(got, want, err_msg=str(c0))
    assert st_t._wav_np is None  # no full host f32 for the viewport path
    full = tenv.wav_to_image(None, nwidth, 60, (-1.0, 1.0), state=st_t)
    np.testing.assert_array_equal(full, jenv.wav_to_image(
        None, nwidth, 60, (-1.0, 1.0), state=st_j))


def test_col_windows_range_above_the_full_limit(rng, monkeypatch):
    wav = rng.standard_normal(3000).astype(np.float32)
    st = tenv.EnvelopeState(wav, device="cpu")
    nwidth = 4096
    full_s, full_e = st.col_windows(nwidth, st.n)
    want = tenv.wav_to_image(wav, nwidth, 50, (-3.0, 3.0), device="cpu")
    monkeypatch.setattr(tenv, "_COLW_FULL_LIMIT", 16)
    for c0, c1 in [(0, 100), (1000, 1033), (4000, 4096)]:
        s, e = st.col_windows_range(nwidth, st.n, c0, c1)
        np.testing.assert_array_equal(s, full_s[c0:c1])
        np.testing.assert_array_equal(e, full_e[c0:c1])
        got = tenv.wav_to_image(None, nwidth, 50, (-3.0, 3.0), state=st,
                                col_range=(c0, c1))
        np.testing.assert_array_equal(got, want[:, c0:c1])


def test_tall_image_and_offscreen_amp_ranges_equal_jax(rng):
    wav = np.clip(rng.standard_normal(2000) * 0.5, -2.0, 2.0).astype(
        np.float32)
    got, want = _both(wav, 8, 40000, (-8.0, 8.0))  # past int16 rows
    np.testing.assert_array_equal(got, want)
    tiny = (rng.standard_normal(20000) * 0.001).astype(np.float32)
    for amp in [(-1.0, 1.0), (5.0, 6.0), (-6.0, -5.0), (-1e-30, 1e-30)]:
        got, want = _both(tiny, 200, 100, amp)
        np.testing.assert_array_equal(got, want, err_msg=str(amp))
    got, want = _both(np.concatenate([np.full(100, -1.0, np.float32),
                                      np.full(100, 1.0, np.float32)]),
                      20, 64, (-1.0, 1.0))  # a sample at amp_min
    np.testing.assert_array_equal(got, want)


def test_from_device_of_a_streamed_wave_equals_a_fresh_state(rng):
    """The reflect-padded wave kept by streaming (sample 0 at win // 2)
    renders exactly as a fresh state of the raw samples and as JAX."""
    from msv_tpu_torch.parallel.streaming import streaming_spec_db

    win, hop = 320, 80
    c = np.zeros((win, 257), np.float32)
    fb = np.zeros((257, 8), np.float32)
    wav = (rng.standard_normal(8000 * 4) * 8000).astype(np.int16)
    *_, wav_dev = streaming_spec_db(wav, win, hop, c, c, fb, chunk_frames=64,
                                    keep_wav=True, device="cpu")
    half = win // 2
    assert torch.equal(wav_dev[half : half + len(wav)],
                       torch.from_numpy(wav))
    st_stream = tenv.EnvelopeState.from_device(wav_dev, len(wav),
                                               offset=half, src_int=wav)
    assert st_stream.origin == "adopted"
    st_j = jenv.EnvelopeState(None, wav, n=len(wav))
    for nwidth, nheight, cr in [(300, 80, None), (40, 50, None),
                                (len(wav) * 2, 40, None),
                                (len(wav) * 2, 40, (1000, 1600)),
                                (300, 80, (17, 90))]:
        got = tenv.wav_to_image(None, nwidth, nheight, (-1.0, 1.0),
                                state=st_stream, col_range=cr)
        want = jenv.wav_to_image(None, nwidth, nheight, (-1.0, 1.0),
                                 state=st_j, col_range=cr)
        np.testing.assert_array_equal(got, want, err_msg=f"{nwidth} {cr}")


# ---------------------------------------------------------------- session


def _tone(sr, seconds, f0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(3 * t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def wav_sessions(tmp_path_factory):
    rng = np.random.default_rng(20261017)
    d = tmp_path_factory.mktemp("torch_envelope")
    paths = []
    for i, (sr, bits, ch) in enumerate([(8000, 16, 1), (22050, 16, 2),
                                        (16000, 32, 1)]):
        x = _tone(sr, 1.7, 300 + 100 * i) + 0.05 * rng.standard_normal(
            int(1.7 * sr)).astype(np.float32)
        p = str(d / f"w{i}.wav")
        write_wav(p, np.stack([x, 0.5 * x])[:ch] if ch == 2 else x, sr,
                  bits=bits)
        paths.append(p)
    ref = msv_tpu.MultiTrack()
    ref.add_tracks([0, 1, 2], paths)
    port = msv_tpu_torch.MultiTrack(device="cpu")
    port.add_tracks([0, 1, 2], paths)
    return ref, port, paths


@pytest.mark.parametrize("tid", [0, 1, 2])
def test_session_wav_image_equals_jax(wav_sessions, tid):
    ref, port, _ = wav_sessions
    for pps, h, amp in [(100.0, 120, (-1.0, 1.0)), (3000.0, 50, (-0.5, 0.7)),
                        (20000.0, 40, (-1.0, 1.0))]:
        got = port.get_wav_image(tid, pps, h, *amp)
        want = ref.get_wav_image(tid, pps, h, *amp)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{pps}")


@pytest.mark.parametrize("tid", [0, 1, 2])
def test_session_wav_image_crop_equals_jax_and_the_full_slice(wav_sessions,
                                                              tid):
    ref, port, _ = wav_sessions
    for pps, a, b in [(700.0, 0.25, 1.1), (20000.0, 0.5, 0.52),
                      (100.0, -1.0, 99.0)]:
        got = port.get_wav_image_crop(tid, pps, 64, -1.0, 1.0, a, b)
        want = ref.get_wav_image_crop(tid, pps, 64, -1.0, 1.0, a, b)
        np.testing.assert_array_equal(got, want, err_msg=f"{pps} {a}")
        full = port.get_wav_image(tid, pps, 64, -1.0, 1.0)
        c0 = max(0, int(np.float32(pps) * np.float32(a)))
        np.testing.assert_array_equal(got, full[:, c0 : c0 + got.shape[1]])


def test_session_replaces_and_drops_envelope_states(wav_sessions):
    _, _, paths = wav_sessions
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [paths[0]])
    a = mt.get_wav_image(0, 100.0, 50, -1.0, 1.0)
    old = mt._env_states[0]
    mt.add_tracks([0], [paths[2]])  # a re-add draws the new file
    new = mt._env_states[0]  # adopted from the new file's row
    assert new is not old and new.origin == "adopted"
    assert new.n == mt.tracks[0].n_samples != old.n
    b = mt.get_wav_image(0, 100.0, 50, -1.0, 1.0)
    assert a.shape != b.shape or not np.array_equal(a, b)
    mt.remove_track(0)
    assert mt._env_states == {}


def test_session_streamed_track_adopts_the_streamed_wave(tmp_path,
                                                         monkeypatch):
    """A streamed track's envelope is the device wave streaming already
    shipped, a one-shot track's its row of the group's batch (no second
    upload either way), and both draw what an uploaded state draws."""
    sr = 8000
    path = str(tmp_path / "x.wav")
    write_wav(path, _tone(sr, 2.0, 220)[None], sr)
    short = msv_tpu_torch.MultiTrack(device="cpu")
    short.add_tracks([0], [path])
    tr = short.tracks[0]
    uploaded = tenv.EnvelopeState(None, tr._wav_int, n=tr.n_samples,
                                  scale=tr.scale, device="cpu")
    img = tenv.wav_to_image(None, 100, 80, (-1.0, 1.0), state=uploaded)

    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 4)
    long = msv_tpu_torch.MultiTrack(device="cpu")
    long.add_tracks([0], [path])
    for mt in (short, long):
        st = mt._env_states[0]  # adopted during add_tracks
        assert (st.origin == "adopted"
                and st.offset == mt.tracks[0].win_length // 2)
        np.testing.assert_array_equal(
            mt.get_wav_image(0, 50.0, 80, -1.0, 1.0), img)
        np.testing.assert_array_equal(
            mt.get_wav_image_crop(0, 50.0, 80, -1.0, 1.0, 0.3, 1.2),
            img[:, 15:60])


# ------------------------------------- grouped tracks adopt their batch row


def _write_pcm32(path, x, sr):
    """A mono 32-bit integer PCM WAV of ``x`` (|x| < 1)."""
    import struct

    raw = np.round(np.asarray(x, np.float64) * 2.0**31).astype("<i4")
    data = raw.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, 4 * sr, 4,
                                        32)
                + b"data" + struct.pack("<I", len(data)) + data)


@pytest.fixture(scope="module")
def wire_paths(wav_sessions, tmp_path_factory):
    """One file a wire: wav_sessions' PCM16 mono ("i16"), stereo PCM16 sum
    (an int32 carrier on the "f32" wire) and float WAV (no integer
    carrier), a 32-bit PCM mono (an int32 carrier, "f32"), and a second
    PCM16 mono at the first one's rate and frame bucket."""
    _, _, paths = wav_sessions
    d = tmp_path_factory.mktemp("torch_envelope_wires")
    rng = np.random.default_rng(25)
    pcm32 = str(d / "pcm32.wav")
    _write_pcm32(pcm32, _tone(11025, 1.6, 520) + 0.05 * rng.standard_normal(
        int(1.6 * 11025)), 11025)
    pair = str(d / "pair.wav")
    write_wav(pair, _tone(8000, 1.5, 640)[None], 8000)
    return {"i16": paths[0], "sum_i32": paths[1], "pcm32": pcm32,
            "float": paths[2], "pair": pair}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _envelope_spans():
    from msv_tpu_torch.utils import profiling

    return [s for s in profiling.recorded() if s.name == "session.envelope"]


def _uploaded(tr):
    """The track's envelope state as the first render ships it."""
    return tenv.EnvelopeState(None if tr._wav_int is not None else tr.wav,
                              tr._wav_int, n=tr.n_samples, scale=tr.scale,
                              device="cpu")


def _wav_views(mt, tid):
    """Full, crop and deep-zoom (crop and full) waveform images."""
    return [mt.get_wav_image(tid, 100.0, 64, -1.0, 1.0),
            mt.get_wav_image_crop(tid, 700.0, 64, -1.0, 1.0, 0.25, 1.1),
            mt.get_wav_image_crop(tid, 40000.0, 64, -0.5, 0.7, 0.5, 0.52),
            mt.get_wav_image(tid, 40000.0, 40, -1.0, 1.0)]


@pytest.mark.parametrize("wire", ["i16", "sum_i32", "pcm32", "float"])
def test_session_grouped_track_adopts_its_row(wire_paths, wire):
    """Right after add_tracks a grouped track's envelope is its row of the
    group's batch: the carrier (times its scale on f32 rows) at
    [win // 2 : win // 2 + n], left so by the route, and every image equal
    to that of a state uploaded from the same carrier."""
    from msv_tpu_torch.utils import profiling

    profiling.clear()
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    with _profile():
        mt.add_tracks([0], [wire_paths[wire]])
    tr = mt.tracks[0]
    carrier = {"i16": (np.int16, "i16"), "sum_i32": (np.int32, "f32"),
               "pcm32": (np.int32, "f32"), "float": (None, "f32")}[wire]
    assert (None if tr._wav_int is None else tr._wav_int.dtype) == (
        carrier[0] and np.dtype(carrier[0])) and tr.wire == carrier[1]
    assert wire != "sum_i32" or tr.n_channels == 2
    st = mt._env_states[0]
    assert st.origin == "adopted" and st.offset == tr.win_length // 2
    body = st.dev[st.offset : st.offset + tr.n_samples]
    if tr.wire == "i16":
        assert torch.equal(body, torch.from_numpy(tr._wav_int))
    else:  # the bits of the host's astype(f32) * f32(scale)
        assert body.dtype == torch.float32
        np.testing.assert_array_equal(body.numpy(), tr.wav)
    (sp,) = _envelope_spans()
    assert sp.attrs == {"origin": "adopted", "tracks": 1,
                        "bytes": st.dev.untyped_storage().nbytes()}
    profiling.clear()
    with _profile():
        adopted = _wav_views(mt, 0)
    assert _envelope_spans() == []  # the first crops ship nothing
    mt._env_states[0] = _uploaded(tr)
    for got, want in zip(adopted, _wav_views(mt, 0)):
        np.testing.assert_array_equal(got, want)


def test_session_two_track_group_rows_own_their_storage(wire_paths):
    """In a group of two each adopted row is a copy of its own (a spill of
    one track frees it); after the spill the next render uploads, records
    one "upload" span and draws the same image."""
    from msv_tpu_torch.utils import profiling

    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0, 1], [wire_paths["i16"], wire_paths["pair"]])
    a, b = mt._env_states[0], mt._env_states[1]
    assert a.origin == b.origin == "adopted"
    assert a.dev.data_ptr() != b.dev.data_ptr()
    tr, st = mt.tracks[1], mt._state[1]
    assert st.n_frames_pad == mt._state[0].n_frames_pad  # one group
    need = (st.n_frames_pad - 1) * tr.hop_length + tr.win_length
    for env in (a, b):
        assert env.dev.untyped_storage().nbytes() == 2 * need  # one int16 row
    want = _wav_views(mt, 1)
    mt._spill_track(1)
    assert 1 not in mt._env_states and mt._track_device_bytes(1) == 0
    profiling.clear()
    with _profile():
        got = _wav_views(mt, 1)
    env = mt._env_states[1]
    (sp,) = _envelope_spans()
    assert env.origin == "upload" and sp.attrs == {
        "origin": "upload", "tracks": 1,
        "bytes": env.dev.untyped_storage().nbytes()}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_session_row_cut_short_takes_the_upload(tmp_path):
    """With a hop over win / 2 (t_overlap 1) a track of 256 frames less a
    few samples outruns its row ((n_frames_pad - 1) * hop + win samples,
    win // 2 of them the reflected edge): no state is adopted, and the
    first render uploads the carrier and draws what an uploaded state
    draws."""
    from msv_tpu_torch.utils import profiling

    setting = msv_tpu_torch.SpecSetting(t_overlap=1)
    sr = 8000
    hop = msv_tpu_torch.derive_stft_params(sr, setting).hop_length
    path = str(tmp_path / "short_row.wav")
    write_wav(path, _tone(sr, (256 * hop - 20) / sr, 330)[None], sr)
    mt = msv_tpu_torch.MultiTrack(setting, device="cpu")
    mt.add_tracks([0], [path])
    tr = mt.tracks[0]
    assert tr.win_length == hop and tr.n_samples == 256 * hop - 20
    need = (mt._state[0].n_frames_pad - 1) * hop + tr.win_length
    assert need - tr.win_length // 2 < tr.n_samples
    assert 0 not in mt._env_states
    profiling.clear()
    with _profile():
        got = _wav_views(mt, 0)
    (sp,) = _envelope_spans()
    assert sp.attrs["origin"] == "upload"
    assert mt._env_states[0].origin == "upload"
    nwidth = int(np.float32(100.0) * np.float32(tr.n_samples)
                 / np.float32(sr))
    np.testing.assert_array_equal(got[0], jenv.wav_to_image(
        None, nwidth, 64, (-1.0, 1.0),
        state=jenv.EnvelopeState(None, tr._wav_int, n=tr.n_samples)))
    mt._env_states[0] = _uploaded(tr)
    for g, w in zip(got, _wav_views(mt, 0)):
        np.testing.assert_array_equal(g, w)
