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
    assert 0 in mt._env_states
    mt.add_tracks([0], [paths[2]])  # a re-add draws the new file
    assert 0 not in mt._env_states
    b = mt.get_wav_image(0, 100.0, 50, -1.0, 1.0)
    assert a.shape != b.shape or not np.array_equal(a, b)
    mt.remove_track(0)
    assert mt._env_states == {}


def test_session_streamed_track_adopts_the_streamed_wave(tmp_path,
                                                         monkeypatch):
    """A streamed track's envelope is the device wave streaming already
    shipped (no second upload) and draws what a one-shot track draws."""
    sr = 8000
    path = str(tmp_path / "x.wav")
    write_wav(path, _tone(sr, 2.0, 220)[None], sr)
    short = msv_tpu_torch.MultiTrack(device="cpu")
    short.add_tracks([0], [path])
    img_short = short.get_wav_image(0, 50.0, 80, -1.0, 1.0)
    assert short._env_states[0].origin == "upload"

    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 4)
    long = msv_tpu_torch.MultiTrack(device="cpu")
    long.add_tracks([0], [path])
    st = long._env_states[0]  # adopted during add_tracks
    assert st.origin == "adopted" and st.offset == long.tracks[0].win_length // 2
    np.testing.assert_array_equal(long.get_wav_image(0, 50.0, 80, -1.0, 1.0),
                                  img_short)
    np.testing.assert_array_equal(
        long.get_wav_image_crop(0, 50.0, 80, -1.0, 1.0, 0.3, 1.2),
        img_short[:, 15:60])
